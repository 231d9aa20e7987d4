"""64-bit integer arithmetic as (hi, lo) uint32 pairs.

Everything 64-bit on the overlap pipeline (murmur3_128, the xorshift
min-reduce stream, signed 64-bit comparisons) is expressed over uint32
pairs, so the kernels run without enabling jax_enable_x64.  The form was
chosen for the earlier target, which had no native 64-bit integer path;
on the GPU it is kept for parity until a native uint64 version is
measured against it.

Representation: a U64 is a tuple (hi, lo) of same-shaped jnp.uint32 arrays.
All ops are elementwise and XLA-fusable.
"""

from __future__ import annotations

import jax.numpy as jnp

U32 = jnp.uint32
_MASK16 = jnp.uint32(0xFFFF)


def const(value: int, shape=()):  # -> U64
    value &= (1 << 64) - 1
    hi = jnp.full(shape, (value >> 32) & 0xFFFFFFFF, dtype=U32)
    lo = jnp.full(shape, value & 0xFFFFFFFF, dtype=U32)
    return hi, lo


def from_u32(x):
    x = x.astype(U32)
    return jnp.zeros_like(x), x


def xor(a, b):
    return a[0] ^ b[0], a[1] ^ b[1]


def shl(a, s: int):
    """Logical shift left by a static amount."""
    hi, lo = a
    if s == 0:
        return hi, lo
    if s >= 64:
        return jnp.zeros_like(hi), jnp.zeros_like(lo)
    if s >= 32:
        return lo << U32(s - 32) if s > 32 else lo, jnp.zeros_like(lo)
    return (hi << U32(s)) | (lo >> U32(32 - s)), lo << U32(s)


def shr(a, s: int):
    """Logical shift right by a static amount (Java >>>)."""
    hi, lo = a
    if s == 0:
        return hi, lo
    if s >= 64:
        return jnp.zeros_like(hi), jnp.zeros_like(lo)
    if s >= 32:
        return jnp.zeros_like(hi), hi >> U32(s - 32) if s > 32 else hi
    return hi >> U32(s), (lo >> U32(s)) | (hi << U32(32 - s))


def rotl(a, r: int):
    r %= 64
    if r == 0:
        return a
    l = shl(a, r)
    h = shr(a, 64 - r)
    return l[0] | h[0], l[1] | h[1]


def add(a, b):
    lo = a[1] + b[1]
    carry = (lo < a[1]).astype(U32)
    hi = a[0] + b[0] + carry
    return hi, lo


def sub(a, b):
    lo = a[1] - b[1]
    borrow = (a[1] < b[1]).astype(U32)
    hi = a[0] - b[0] - borrow
    return hi, lo


def neg(a):
    return add((~a[0], ~a[1]), const(1, a[0].shape if hasattr(a[0], "shape") else ()))


def _mul32_full(a, b):
    """32x32 -> 64 unsigned multiply, (hi, lo) uint32."""
    a0 = a & _MASK16
    a1 = a >> U32(16)
    b0 = b & _MASK16
    b1 = b >> U32(16)
    ll = a0 * b0
    m1 = a0 * b1
    m2 = a1 * b0
    hh = a1 * b1
    t = (ll >> U32(16)) + (m1 & _MASK16) + (m2 & _MASK16)
    lo = (t << U32(16)) | (ll & _MASK16)
    hi = hh + (m1 >> U32(16)) + (m2 >> U32(16)) + (t >> U32(16))
    return hi, lo


def mul(a, b):
    """Full 64x64 multiply mod 2**64."""
    hi, lo = _mul32_full(a[1], b[1])
    hi = hi + a[1] * b[0] + a[0] * b[1]
    return hi, lo


def mul_const(a, value: int):
    return mul(a, const(value, a[0].shape if hasattr(a[0], "shape") else ()))


def eq(a, b):
    return (a[0] == b[0]) & (a[1] == b[1])


def signed_lt(a, b):
    """Java (long)a < (long)b on (hi, lo) pairs."""
    sa = a[0] ^ U32(0x80000000)
    sb = b[0] ^ U32(0x80000000)
    return (sa < sb) | ((sa == sb) & (a[1] < b[1]))


def unsigned_lt(a, b):
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))


def select(pred, a, b):
    return jnp.where(pred, a[0], b[0]), jnp.where(pred, a[1], b[1])


def xorshift(x):
    """One step of MHAP's xorshift64 stream (MinHashSketch.java:139-142):
    x ^= x << 21; x ^= x >>> 35; x ^= x << 4.
    """
    x = xor(x, shl(x, 21))
    x = xor(x, shr(x, 35))
    x = xor(x, shl(x, 4))
    return x


def to_numpy(a):
    """(hi, lo) -> numpy uint64 (host-side, for tests)."""
    import numpy as np

    hi = np.asarray(a[0], dtype=np.uint64)
    lo = np.asarray(a[1], dtype=np.uint64)
    return (hi << np.uint64(32)) | lo
