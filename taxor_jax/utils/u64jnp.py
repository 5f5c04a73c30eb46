"""64-bit hash math on device as (hi, lo) uint32 pairs.

JAX runs with 32-bit integers by default (x64 off), so the probe-position
math (murmur mix + rotations + Lemire reduce, utils/u64np.py) works on
uint32 pairs: a handful of 64-bit ops, with limb products for the
widening multiplies.  Bit-exact against the numpy uint64 reference
(tested).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32
# numpy scalars (NOT jnp arrays): they lower to jaxpr literals, not
# captured constants
_MASK16 = np.uint32(0xFFFF)

_M1_HI = np.uint32(0xFF51AFD7)
_M1_LO = np.uint32(0xED558CCD)
_M2_HI = np.uint32(0xC4CEB9FE)
_M2_LO = np.uint32(0x1A85EC53)


# All widening multiplies go through 11-bit limbs multiplied EXACTLY in
# float32 (products < 2^22, partial sums < 3*2^22 < 2^24, both inside the
# f32 mantissa), recombined with integer shifts/adds.  Exact on every
# backend; a native uint32/uint64 multiply is a possible simplification.
# Bit-exact vs the numpy uint64 reference (tested).
_MASK11 = np.uint32(0x7FF)


import jax.lax as _lax


def _u32_to_f32(x):
    """Exact u32 -> f32 for values < 2^24 (all limb inputs) routed via
    int32 (the bitcast is free).  numpy scalars (compile-time constants)
    convert directly."""
    if isinstance(x, (int, np.integer)):
        return np.float32(x)
    return _lax.bitcast_convert_type(x, jnp.int32).astype(jnp.float32)


def _f32_to_u32(x):
    """Exact f32 -> u32 for 0 <= x < 2^31 via int32 (see _u32_to_f32)."""
    if isinstance(x, (float, np.floating)):
        return np.uint32(x)
    return _lax.bitcast_convert_type(x.astype(jnp.int32), U32)


def _limbs3(x):
    if isinstance(x, (int, np.integer)):
        x = np.uint32(x)
    else:
        x = x.astype(U32)
    return (
        _u32_to_f32(x & _MASK11),
        _u32_to_f32((x >> 11) & _MASK11),
        _u32_to_f32(x >> 22),
    )


def _limb_products(a, b):
    """Per-power partial sums c0..c4 (exact float32) of a*b via 11-bit
    limbs: a*b = sum_k c_k * 2^(11k)."""
    a0, a1, a2 = _limbs3(a)
    b0, b1, b2 = _limbs3(b)
    c0 = a0 * b0
    c1 = a0 * b1 + a1 * b0
    c2 = a0 * b2 + a1 * b1 + a2 * b0
    c3 = a1 * b2 + a2 * b1
    c4 = a2 * b2
    return (
        _f32_to_u32(c0),
        _f32_to_u32(c1),
        _f32_to_u32(c2),
        _f32_to_u32(c3),
        _f32_to_u32(c4),
    )


def umul32_full(a, b):
    """(hi, lo) of the 64-bit product of two uint32 arrays."""
    c0, c1, c2, c3, c4 = _limb_products(a, b)
    u1_lo = c1 << 11
    u1_hi = c1 >> 21
    u2_lo = c2 << 22
    u2_hi = c2 >> 10
    s1 = c0 + u1_lo
    carry1 = (s1 < c0).astype(U32)
    lo = s1 + u2_lo
    carry2 = (lo < s1).astype(U32)
    hi = u1_hi + u2_hi + carry1 + carry2 + (c3 << 1) + (c4 << 12)
    return hi, lo


def umul32_lo(a, b):
    """Low 32 bits of a 32x32 product (wrapping)."""
    c0, c1, c2, _, _ = _limb_products(a, b)
    return c0 + (c1 << 11) + (c2 << 22)


def add64(ahi, alo, bhi, blo):
    lo = alo + blo
    carry = (lo < alo).astype(U32)
    hi = ahi + bhi + carry
    return hi, lo


def mul64_lo(ahi, alo, bhi, blo):
    """Low 64 bits of a 64x64 product as a (hi, lo) pair."""
    hi0, lo = umul32_full(alo, blo)
    hi = hi0 + umul32_lo(alo, bhi) + umul32_lo(ahi, blo)
    return hi, lo


def xor64(ahi, alo, bhi, blo):
    return ahi ^ bhi, alo ^ blo


def shr64(ahi, alo, s: int):
    """Logical right shift by a static amount."""
    if s == 0:
        return ahi, alo
    if s < 32:
        lo = (alo >> s) | (ahi << (32 - s))
        hi = ahi >> s
        return hi, lo
    if s == 32:
        return jnp.zeros_like(ahi), ahi
    return jnp.zeros_like(ahi), ahi >> (s - 32)


def rotl64(ahi, alo, s: int):
    s = s % 64
    if s == 0:
        return ahi, alo
    if s == 32:
        return alo, ahi
    if s < 32:
        hi = (ahi << s) | (alo >> (32 - s))
        lo = (alo << s) | (ahi >> (32 - s))
        return hi, lo
    return rotl64(alo, ahi, s - 32)


def murmur64(hi, lo):
    """murmur3 finalizer on (hi, lo) pairs (utils/u64np.murmur64)."""
    hi, lo = xor64(hi, lo, *shr64(hi, lo, 33))
    hi, lo = mul64_lo(hi, lo, _M1_HI, _M1_LO)
    hi, lo = xor64(hi, lo, *shr64(hi, lo, 33))
    hi, lo = mul64_lo(hi, lo, _M2_HI, _M2_LO)
    hi, lo = xor64(hi, lo, *shr64(hi, lo, 33))
    return hi, lo


def mix_split(khi, klo, seed_hi, seed_lo):
    """murmur64(key + seed) — the XOR-filter hash family."""
    hi, lo = add64(khi, klo, seed_hi, seed_lo)
    return murmur64(hi, lo)


def umul64_full(ahi, alo, bhi, blo):
    """Full 128-bit product of two (hi, lo) uint32-pair uint64s.

    Returns ((r3, r2), (r1, r0)): the high and low 64-bit halves, each as
    a (hi, lo) uint32 pair."""
    a_hi, a_lo = umul32_full(alo, blo)  # xl*yl
    b_hi, b_lo = umul32_full(alo, bhi)  # xl*yh  << 32
    c_hi, c_lo = umul32_full(ahi, blo)  # xh*yl  << 32
    d_hi, d_lo = umul32_full(ahi, bhi)  # xh*yh  << 64
    s1 = a_hi + b_lo
    carry1 = (s1 < a_hi).astype(U32)
    s2 = s1 + c_lo
    carry2 = (s2 < s1).astype(U32)
    # bits 64..95
    u1 = b_hi + c_hi
    carry_a = (u1 < b_hi).astype(U32)
    u2 = u1 + d_lo
    carry_b = (u2 < u1).astype(U32)
    u3 = u2 + carry1 + carry2
    carry_c = (u3 < u2).astype(U32)
    r3 = d_hi + carry_a + carry_b + carry_c
    return (r3, u3), (s2, a_lo)


_WY_HI = np.uint32(0x9E3779B9)
_WY_LO = np.uint32(0x7F4A7C15)


def wyhash64(khi, klo):
    """ankerl unordered_dense wyhash of a uint64 key as (hi, lo) pairs:
    hi64(x*C) ^ lo64(x*C) with C the golden-ratio constant — bit-exact
    against utils/u64np.wyhash64 (the canonical k-mer hash,
    src/hashing/syncmer.cpp:73-77)."""
    (r3, r2), (r1, r0) = umul64_full(khi, klo, _WY_HI, _WY_LO)
    return r3 ^ r1, r2 ^ r0


def reduce32(r, n):
    """(uint32(r) * n) >> 32 with n a (traced or static) uint32 scalar."""
    hi, _ = umul32_full(r, n)
    return hi


def probe_positions_and_fprint(khi, klo, seed_hi, seed_lo, block_length):
    """Device analog of ixf.compute_probes.

    Returns (pos int32 [..., 3], fpr uint8 fingerprint byte) from uint32
    hash pairs; block_length is a uint32 scalar (traced — one compilation
    serves every IXF geometry).
    """
    hi, lo = mix_split(khi, klo, seed_hi, seed_lo)
    bl = block_length.astype(U32)
    p0 = reduce32(lo, bl)
    h1hi, h1lo = rotl64(hi, lo, 21)
    p1 = reduce32(h1lo, bl) + bl
    h2hi, h2lo = rotl64(hi, lo, 42)
    p2 = reduce32(h2lo, bl) + bl + bl
    pos = jnp.stack(
        [p0.astype(jnp.int32), p1.astype(jnp.int32), p2.astype(jnp.int32)],
        axis=-1,
    )
    return pos, ((hi ^ lo) & jnp.uint32(0xFF)).astype(jnp.uint8)
