"""Stage-2 bottom-k (hash, position) sketch kernel.

Parity target: sketch/BottomOverlapSketch.java:525-559 -- murmur3_32 every
k-mer (non-canonical), stable radix sort by signed hash, keep the bottom
min(sketch_size, n) entries as (hash, position) pairs.

Device formulation: one ``lax.sort`` over the padded [B, n] hash matrix with
(validity, hash, position) keys; the bottom ``sketch_size`` slice is the
sketch.  Entries past a read's true k-mer count are masked with
hash = INT32_MAX sentinels and an explicit count so downstream kernels can
ignore them (the sentinel itself is never trusted).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

I32 = jnp.int32
PAD_HASH = jnp.int32(0x7FFFFFFF)
PAD_POS = jnp.int32(0x7FFFFFFF)


@partial(jax.jit, static_argnames=("sketch_size",))
def bottom_sketch(hashes: jnp.ndarray, valid: jnp.ndarray, *, sketch_size: int):
    """hashes: [B, n] int32 (murmur3_32 of each k-mer window);
    valid: [B, n] bool.

    Returns (hash int32 [B, S], pos int32 [B, S], m int32 [B]) with
    S = sketch_size; entries >= m[b] are PAD sentinels.
    """
    B, n = hashes.shape
    pos = jnp.broadcast_to(jnp.arange(n, dtype=I32), (B, n))
    inval = (~valid).astype(jnp.uint32)
    _, s_hash, s_pos = jax.lax.sort((inval, hashes, pos), dimension=1,
                                    num_keys=3)
    S = min(sketch_size, n)
    out_h = s_hash[:, :S]
    out_p = s_pos[:, :S]
    n_valid = jnp.sum(valid, axis=1).astype(I32)
    m = jnp.minimum(n_valid, S)
    in_range = jnp.arange(S, dtype=I32)[None, :] < m[:, None]
    out_h = jnp.where(in_range, out_h, PAD_HASH)
    out_p = jnp.where(in_range, out_p, PAD_POS)
    if S < sketch_size:
        pad = sketch_size - S
        out_h = jnp.pad(out_h, ((0, 0), (0, pad)), constant_values=PAD_HASH)
        out_p = jnp.pad(out_p, ((0, 0), (0, pad)), constant_values=PAD_POS)
    return out_h, out_p, m
