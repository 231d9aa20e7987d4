"""Batched murmur3 k-mer hashing on device (JAX/XLA, uint32 arithmetic only).

Computes the same values as guava's murmur3 over the UTF-16 chars of Java
k-mer substrings (reference sketch/HashUtils.java:237-258 / :213-235):

* ``kmer_hashes_128(seq, k, seed)`` -> h1 ("asLong") of murmur3 x64_128 per
  k-mer window, as a (hi, lo) uint32 pair -- the stage-1 identity hash.
* ``kmer_hashes_32(seq, k, seed)``  -> murmur3 x86_32 per window (int32) --
  the stage-2 ordered-sketch hash.

Input is a [B, L] uint8 matrix of ASCII sequence codes (A/C/G/T/N/...,
already uppercased); every window position is hashed, the caller masks
positions >= length-k+1.  Each ASCII char contributes the UTF-16LE byte pair
(code, 0x00), so a k-mer is 2k hash bytes; chars are consumed 2-per-uint32
(lo char first), 4-per-uint64-word.

The whole computation is elementwise over k shifted [B, n] views, so XLA
fuses it into a handful of VPU loops; no Pallas needed at this level.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import u64

U32 = jnp.uint32

_C1_128 = 0x87C37B91114253D5
_C2_128 = 0x4CF5AD432745937F


def _windows(seq: jnp.ndarray, k: int):
    """k shifted views [B, n] (n = L-k+1) of the char codes, as uint32."""
    B, L = seq.shape
    n = L - k + 1
    return [seq[:, j:j + n].astype(U32) for j in range(k)]


def _fmix64(h):
    h = u64.xor(h, u64.shr(h, 33))
    h = u64.mul(h, u64.const(0xFF51AFD7ED558CCD))
    h = u64.xor(h, u64.shr(h, 33))
    h = u64.mul(h, u64.const(0xC4CEB9FE1A85EC53))
    h = u64.xor(h, u64.shr(h, 33))
    return h


def kmer_hashes_128(seq: jnp.ndarray, k: int, seed: int = 0):
    """Guava murmur3_128 h1 over UTF-16 chars of every k-mer window.

    seq: [B, L] uint8. Returns (hi, lo) uint32 pair, each [B, L-k+1].
    """
    c = _windows(seq, k)
    n_shape = c[0].shape
    nbytes = 2 * k

    # Java: long h1 = seed (int sign-extended)
    seed_hi = 0xFFFFFFFF if (seed & 0x80000000) else 0
    h1 = (jnp.full(n_shape, seed_hi, U32), jnp.full(n_shape, seed & 0xFFFFFFFF, U32))
    h2 = h1

    C1 = u64.const(_C1_128)
    C2 = u64.const(_C2_128)

    def u64_word(j):
        """u64 from chars j..j+3 (UTF-16LE), zero-padded past the k-mer."""
        def ch(i):
            return c[i] if i < k else jnp.zeros(n_shape, U32)
        lo = ch(j) | (ch(j + 1) << U32(16))
        hi = ch(j + 2) | (ch(j + 3) << U32(16))
        return hi, lo

    nblocks = nbytes // 16  # = k // 8
    for b in range(nblocks):
        k1 = u64_word(8 * b)
        k2 = u64_word(8 * b + 4)

        k1 = u64.mul(k1, C1)
        k1 = u64.rotl(k1, 31)
        k1 = u64.mul(k1, C2)
        h1 = u64.xor(h1, k1)
        h1 = u64.rotl(h1, 27)
        h1 = u64.add(h1, h2)
        h1 = u64.add(u64.mul(h1, u64.const(5)), u64.const(0x52DCE729))

        k2 = u64.mul(k2, C2)
        k2 = u64.rotl(k2, 33)
        k2 = u64.mul(k2, C1)
        h2 = u64.xor(h2, k2)
        h2 = u64.rotl(h2, 31)
        h2 = u64.add(h2, h1)
        h2 = u64.add(u64.mul(h2, u64.const(5)), u64.const(0x38495AB5))

    tail = nbytes - nblocks * 16  # = 2 * (k % 8), always even
    if tail > 0:
        j0 = 8 * nblocks
        if tail > 8:
            k2 = u64_word(j0 + 4)
            k2 = u64.mul(k2, C2)
            k2 = u64.rotl(k2, 33)
            k2 = u64.mul(k2, C1)
            h2 = u64.xor(h2, k2)
        k1 = u64_word(j0)
        k1 = u64.mul(k1, C1)
        k1 = u64.rotl(k1, 31)
        k1 = u64.mul(k1, C2)
        h1 = u64.xor(h1, k1)

    ln = u64.const(nbytes)
    h1 = u64.xor(h1, (jnp.zeros(n_shape, U32), jnp.full(n_shape, nbytes, U32)))
    h2 = u64.xor(h2, (jnp.zeros(n_shape, U32), jnp.full(n_shape, nbytes, U32)))
    del ln
    h1 = u64.add(h1, h2)
    h2 = u64.add(h2, h1)
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    h1 = u64.add(h1, h2)
    # guava asLong() == h1 (h2 never escapes on the overlap path)
    return h1


def kmer_hashes_32(seq: jnp.ndarray, k: int, seed: int = 0) -> jnp.ndarray:
    """Guava murmur3_32 over UTF-16 chars of every k-mer window.

    seq: [B, L] uint8. Returns int32 [B, L-k+1] (signed, as Java ints).
    """
    c = _windows(seq, k)
    n_shape = c[0].shape
    nbytes = 2 * k
    C1 = U32(0xCC9E2D51)
    C2 = U32(0x1B873593)

    h1 = jnp.full(n_shape, seed & 0xFFFFFFFF, U32)

    def rotl32(x, r):
        return (x << U32(r)) | (x >> U32(32 - r))

    nblocks = nbytes // 4  # = k // 2
    for b in range(nblocks):
        k1 = c[2 * b] | (c[2 * b + 1] << U32(16))
        k1 = k1 * C1
        k1 = rotl32(k1, 15)
        k1 = k1 * C2
        h1 = h1 ^ k1
        h1 = rotl32(h1, 13)
        h1 = h1 * U32(5) + U32(0xE6546B64)

    if k % 2 == 1:  # 2-byte tail (one char)
        k1 = c[k - 1]
        k1 = k1 * C1
        k1 = rotl32(k1, 15)
        k1 = k1 * C2
        h1 = h1 ^ k1

    h1 = h1 ^ U32(nbytes)
    h1 = h1 ^ (h1 >> U32(16))
    h1 = h1 * U32(0x85EBCA6B)
    h1 = h1 ^ (h1 >> U32(13))
    h1 = h1 * U32(0xC2B2AE35)
    h1 = h1 ^ (h1 >> U32(16))
    return h1.astype(jnp.int32)
