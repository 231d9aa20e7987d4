"""Design measurements for the 40k-regime (wide-store) vote rewrite.

Times the candidate building blocks at reference scale (N ~ 80k postings
per band, H = 512) on the real chip:

  join1     global join sort [H, N+Q] (4-operand, 2 keys)  -- once per run
  unsort    rank unsort [H, N+Q] (packed key + 1 payload)  -- once per run
  gatherEx  span expansion by take_along_axis  [H, Qc*span] from [H, N]
  sortEx    span expansion by request sort-join [H, N + Qc*span] (current)
  vcount    vote-count sort [Qc, H*span]
  cummax    one [H, M] u32 cummax (channel-path unit cost)

Every measured program reduces its outputs to ONE i32 checksum inside the
jit (only pulled results measure truly; single-output consumption
DCEs the rest).
"""
import sys
import time
from functools import partial

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp

I32 = jnp.int32
U32 = jnp.uint32


def timed(fn, args, iters=3, label=""):
    t0 = time.perf_counter()
    out = np.asarray(fn(*args))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = np.asarray(fn(*args))
        times.append(time.perf_counter() - t0)
    med = sorted(times)[len(times) // 2]
    print(f"{label:10s} compile {compile_s:7.2f}s  steady {med*1e3:9.2f}ms"
          f"  (all {[round(t*1e3,1) for t in times]})  chk={int(out)}",
          flush=True)
    return med


def main(N=80_000, Q=40_000, H=512, Qc=1024, span=64):
    print(f"N={N} Q={Q} H={H} Qc={Qc} span={span}", flush=True)
    rng = np.random.default_rng(0)
    M = N + Q
    # synthetic postings: values clustered so runs have realistic sizes
    vals_np = rng.integers(0, N // 8, (H, N), dtype=np.int32)
    vals_np.sort(axis=1)
    sids_np = rng.permutation(np.broadcast_to(
        np.arange(N, dtype=np.int32), (H, N)).T).T.copy()
    qmh_np = rng.integers(0, N // 8, (Q, H), dtype=np.int32)
    post_vals = jax.device_put(vals_np)
    post_sids = jax.device_put(sids_np)
    qmh = jax.device_put(qmh_np)
    left_np = rng.integers(0, N - span, (Qc, H), dtype=np.int32)
    left = jax.device_put(left_np)

    @jax.jit
    def join1(post_vals, post_sids, qT):
        j_vals = jnp.concatenate([post_vals, qT], axis=1)
        j_tag = jnp.concatenate(
            [jnp.zeros((H, N), I32), jnp.ones((H, Q), I32)], axis=1)
        j_pay = jnp.concatenate(
            [jnp.broadcast_to(jnp.arange(N, dtype=I32), (H, N)),
             jnp.broadcast_to(jnp.arange(Q, dtype=I32), (H, Q))], axis=1)
        j_sid = jnp.concatenate([post_sids, jnp.zeros((H, Q), I32)], axis=1)
        s_val, s_tag, s_pay, s_sid = jax.lax.sort(
            (j_vals, j_tag, j_pay, j_sid), dimension=1, num_keys=2)
        return (jnp.sum(s_val) + jnp.sum(s_tag) + jnp.sum(s_pay)
                + jnp.sum(s_sid)).astype(I32)

    timed(join1, (post_vals, post_sids, qmh.T), label="join1")

    key_np = rng.integers(0, 2**31, (H, M), dtype=np.int64).astype(np.uint32)
    lr_np = rng.integers(0, 2**31, (H, M), dtype=np.int64).astype(np.uint32)
    keyd = jax.device_put(key_np)
    lrd = jax.device_put(lr_np)

    @jax.jit
    def unsort(key, lr):
        sk, sl = jax.lax.sort((key, lr), dimension=1, num_keys=1)
        return (jnp.sum(sk) + jnp.sum(sl)).astype(I32)

    timed(unsort, (keyd, lrd), label="unsort")

    @jax.jit
    def gather_ex(post_sids, left):
        offs = jnp.arange(span, dtype=I32)
        idx = (left.T[:, :, None] + offs[None, None, :]).reshape(
            H, Qc * span)
        idx = jnp.clip(idx, 0, N - 1)
        cand = jnp.take_along_axis(post_sids, idx, axis=1)
        return jnp.sum(cand).astype(I32)

    timed(gather_ex, (post_sids, left), label="gatherEx")

    # gather variant: transpose first so gather runs along the major axis
    @jax.jit
    def gather_ex_T(post_sids, left):
        offs = jnp.arange(span, dtype=I32)
        idx = (left[:, :, None] + offs[None, None, :])  # [Qc, H, span]
        idx = jnp.clip(idx, 0, N - 1)
        pT = post_sids.T  # [N, H]
        cand = jnp.take_along_axis(
            pT[:, :, None], idx.transpose(1, 0, 2), axis=0)
        return jnp.sum(cand).astype(I32)

    try:
        timed(gather_ex_T, (post_sids, left), label="gatherExT")
    except Exception as e:
        print(f"gatherExT failed: {e}", flush=True)

    from mhap_tpu.index.postings import _expand_spans_sortjoin

    @jax.jit
    def sort_ex(post_sids, left):
        cnt = jnp.full((Qc, H), span, I32)
        cand = _expand_spans_sortjoin(post_sids, left, cnt, span, N,
                                      Qc, H)
        return jnp.sum(cand).astype(I32)

    timed(sort_ex, (post_sids, left), label="sortEx")

    flat_np = rng.integers(0, N + 1, (Qc, H * span), dtype=np.int32)
    flatd = jax.device_put(flat_np)

    @jax.jit
    def vcount(flat):
        s = jnp.sort(flat, axis=1)
        return jnp.sum(s).astype(I32)

    timed(vcount, (flatd,), label="vcount")

    @jax.jit
    def cummax1(key):
        return jnp.sum(jax.lax.cummax(key, axis=1)).astype(I32)

    timed(cummax1, (keyd,), label="cummax")


if __name__ == "__main__" and "phase2" not in sys.argv and "phase3" not in sys.argv:
    kw = {}
    for a in sys.argv[1:]:
        k, v = a.split("=")
        kw[k] = int(v)
    main(**kw)


def main2(N=80_000, Q=40_000, H=512, span=16):
    """Phase-2 measurements: the channel+unsort transport pipeline."""
    print(f"[transport] N={N} Q={Q} H={H} span={span}", flush=True)
    rng = np.random.default_rng(0)
    M = N + Q
    key_np = rng.integers(0, 2**18, (H, M), dtype=np.int64).astype(np.uint32)
    keyd = jax.device_put(key_np)
    chans_np = [rng.integers(0, 2**17, (H, M), dtype=np.int64)
                .astype(np.uint32) for _ in range(span)]
    chansd = [jax.device_put(c) for c in chans_np]

    @jax.jit
    def unsort_many(key, *chs):
        out = jax.lax.sort((key,) + chs, dimension=1, num_keys=1)
        acc = jnp.sum(out[0]).astype(I32)
        for o in out[1:]:
            acc = acc + jnp.sum(o).astype(I32)
        return acc

    timed(unsort_many, (keyd, *chansd), label=f"unsort{span+1}")

    # transpose [H, Q] x span (u32) -> [Q, H*span] i32 (candidate layout)
    qcols = [jax.device_put(c[:, :Q]) for c in chans_np]

    @jax.jit
    def to_qmajor(*cols):
        # [span, H, Q] -> [Q, H, span] -> [Q, H*span]
        st = jnp.stack(cols, axis=0).transpose(2, 1, 0).reshape(Q, H * span)
        return jnp.sum(st).astype(I32)

    timed(to_qmajor, tuple(qcols), label="toQmajor")

    # channels: 2 cummaxes per d (split-sid) over [H, M], span of them,
    # in ONE jit (fusion/overlap may help)
    tagd = jax.device_put((rng.random((H, M)) < (N / M)).astype(np.int32))
    payd = jax.device_put(
        rng.integers(0, 2**17, (H, M), dtype=np.int64).astype(np.uint32))

    @jax.jit
    def channels_all(tag, pay, key):
        rel = (key % 64).astype(I32)  # stand-in for in-run offset
        acc = jnp.zeros((), I32)
        for d in range(span):
            sel = (rel == d) & (tag == 0)
            a = jax.lax.cummax(jnp.where(sel, pay << U32(15)
                                         | (key & U32(0x7FFF)), U32(0)),
                               axis=1)
            b = jax.lax.cummax(jnp.where(sel, pay << U32(15)
                                         | (key >> U32(3) & U32(0x7FFF)),
                                         U32(0)), axis=1)
            acc = acc + jnp.sum(a & U32(0x7FFF)).astype(I32) \
                + jnp.sum(b & U32(0x7FFF)).astype(I32)
        return acc

    timed(channels_all, (tagd, payd, keyd), label="channels")

    # residual gather: small flat gather (heavy-run postings)
    R = 500_000
    sids_np = rng.integers(0, 2**17, (H, N), dtype=np.int64).astype(np.int32)
    sidsd = jax.device_put(sids_np)
    ridx = jax.device_put(
        rng.integers(0, N, (R,), dtype=np.int64).astype(np.int32))
    rh = jax.device_put(
        rng.integers(0, H, (R,), dtype=np.int64).astype(np.int32))

    @jax.jit
    def resid_gather(sids, rh, ridx):
        return jnp.sum(sids[rh, ridx]).astype(I32)

    timed(resid_gather, (sidsd, rh, ridx), label="residG")


if __name__ == "__main__" and "phase2" in sys.argv:
    main2()


def main3(N=80_000, Q=40_000, H=512):
    """Unsort operand-count sweep: compile vs runtime."""
    rng = np.random.default_rng(0)
    M = N + Q
    key_np = rng.integers(0, 2**18, (H, M), dtype=np.int64).astype(np.uint32)
    keyd = jax.device_put(key_np)

    for npay, dtype in ((4, np.uint32), (8, np.uint32), (8, np.uint64)):
        chans = [jax.device_put(
            rng.integers(0, 2**17, (H, M), dtype=np.int64).astype(dtype))
            for _ in range(npay)]

        @jax.jit
        def unsort_many(key, *chs):
            out = jax.lax.sort((key,) + chs, dimension=1, num_keys=1)
            acc = jnp.sum(out[0]).astype(I32)
            for o in out[1:]:
                acc = acc + jnp.sum(o).astype(I32)
            return acc

        timed(unsort_many, (keyd, *chans),
              label=f"uns{npay+1}_{np.dtype(dtype).name[-2:]}")


if __name__ == "__main__" and "phase3" in sys.argv:
    main3()
