"""Microbenchmark the sketch pipeline sub-stages on the GPU."""
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp

from mhap_tpu.ops import bottomk as BK
from mhap_tpu.ops import minhash as M
from mhap_tpu.ops import murmur3 as M3

B, L, H, S = 256, 2944, 512, 1536
k1, k2 = 16, 12
rng = np.random.default_rng(0)
seq = jnp.asarray(rng.choice(np.frombuffer(b"ACGT", np.uint8), (B, L)))
lens = jnp.asarray(np.full(B, 2900, np.int32))


def timeit(name, fn, reps=3):
    out = fn()
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
        jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    print(f"{name:>24}: {dt*1000:9.1f} ms/call  ({dt*8*1000:.0f} ms per 2048 rows)",
          flush=True)
    return out


h128 = jax.jit(lambda s: M3.kmer_hashes_128(s, k1, 0))
h32 = jax.jit(lambda s: M3.kmer_hashes_32(s, k2, 0))
n1 = L - k1 + 1
valid1 = jnp.arange(n1)[None, :] < (lens[:, None] - k1 + 1)
sc = jax.jit(lambda hi, lo: M.sort_and_count(hi, lo, valid1))
bot = jax.jit(lambda h: BK.bottom_sketch(
    h, jnp.arange(L - k2 + 1)[None, :] < (lens[:, None] - k2 + 1),
    sketch_size=S))

hi, lo = timeit("murmur3_128", lambda: h128(seq))
timeit("murmur3_32", lambda: h32(seq))
g = timeit("sort_and_count", lambda: sc(hi, lo))
h32v = h32(seq)
timeit("bottom_sketch", lambda: bot(h32v))

w = jnp.where(g["first"], jnp.minimum(g["count"], 4), 0)
act = g["first"] & (w > 0)
timeit("min_reduce scan w4", lambda: M.weighted_min_reduce(
    g["hi"], g["lo"], w, act, g["tiebreak"], num_hashes=H, w_max=4))

# the fused whole-chunk jit (what the pipeline actually calls)
from mhap_tpu.pipeline.overlapper import _sketch_fused_jit
timeit("fused chunk", lambda: _sketch_fused_jit(seq, lens, k1, k2, H, S, 4))

# host->device transfer cost for one chunk
codes = np.asarray(seq)
def push():
    return jax.device_put(codes).block_until_ready()
timeit("h2d seq transfer", push)
