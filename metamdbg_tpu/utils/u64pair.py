"""u64 arithmetic as (lo, hi) uint32 pairs for the device kernels.

JAX runs with 32-bit integers unless x64 mode is enabled process-wide, and
GPUs have no native 64-bit integer multiply either (it is emulated with
several 32-bit instructions), so the device kernels model u64 values as two
uint32 arrays ``(lo, hi)``. This module provides the full set of u64 ops
needed for bit-exact MurmurHash3 (see utils/hashing.py for the semantics
being matched) plus the murmur hashes themselves. Everything is
shape-polymorphic plain jnp code.

All functions take/return uint32 arrays; Python ints are accepted for
constants.
"""

import jax.numpy as jnp
import numpy as np

# numpy scalars (not jnp arrays) so Pallas kernels treat them as literals
_MASK16 = np.uint32(0xFFFF)


def split(value: int):
    """Split a Python int constant into (lo, hi) uint32 scalars."""
    return (np.uint32(value & 0xFFFFFFFF),
            np.uint32((value >> 32) & 0xFFFFFFFF))


def mul32x32(a, b):
    """Full 32x32 -> 64 bit product as (lo, hi), u32-only arithmetic."""
    a = a.astype(jnp.uint32)
    b = b.astype(jnp.uint32)
    a0 = a & _MASK16
    a1 = a >> 16
    b0 = b & _MASK16
    b1 = b >> 16
    lolo = a0 * b0
    mid1 = a1 * b0
    mid2 = a0 * b1
    hihi = a1 * b1
    t = (lolo >> 16) + (mid1 & _MASK16) + (mid2 & _MASK16)
    lo = (lolo & _MASK16) | ((t & _MASK16) << 16)
    hi = hihi + (mid1 >> 16) + (mid2 >> 16) + (t >> 16)
    return lo, hi


def mul(alo, ahi, blo, bhi):
    """u64 multiply (low 64 bits of product)."""
    lo, hi = mul32x32(alo, blo)
    hi = hi + alo * bhi + ahi * blo  # u32 wraparound == low-32 contribution
    return lo, hi


def mul_const(alo, ahi, c: int):
    clo, chi = split(c)
    return mul(alo, ahi, clo, chi)


def add(alo, ahi, blo, bhi):
    lo = alo + blo
    carry = (lo < alo).astype(jnp.uint32)
    hi = ahi + bhi + carry
    return lo, hi


def add_const(alo, ahi, c: int):
    clo, chi = split(c)
    return add(alo, ahi, clo, chi)


def xor(alo, ahi, blo, bhi):
    return alo ^ blo, ahi ^ bhi


def xor_const(alo, ahi, c: int):
    clo, chi = split(c)
    return alo ^ clo, ahi ^ chi


def shr(alo, ahi, r: int):
    """Logical right shift by a static amount 0 < r < 64."""
    if r == 0:
        return alo, ahi
    if r < 32:
        lo = (alo >> r) | (ahi << (32 - r))
        hi = ahi >> r
    elif r == 32:
        lo, hi = ahi, jnp.zeros_like(ahi)
    else:
        lo = ahi >> (r - 32)
        hi = jnp.zeros_like(ahi)
    return lo, hi


def shl(alo, ahi, r: int):
    """Left shift by a static amount 0 < r < 64."""
    if r == 0:
        return alo, ahi
    if r < 32:
        hi = (ahi << r) | (alo >> (32 - r))
        lo = alo << r
    elif r == 32:
        hi, lo = alo, jnp.zeros_like(alo)
    else:
        hi = alo << (r - 32)
        lo = jnp.zeros_like(alo)
    return lo, hi


def rotl(alo, ahi, r: int):
    llo, lhi = shl(alo, ahi, r)
    rlo, rhi = shr(alo, ahi, 64 - r)
    return llo | rlo, lhi | rhi


def lt(alo, ahi, blo, bhi):
    """Unsigned u64 a < b."""
    return (ahi < bhi) | ((ahi == bhi) & (alo < blo))


def to_f64_approx(alo, ahi):
    """Approximate float64 value (exact when JAX x64 is enabled)."""
    return ahi.astype(jnp.float64) * jnp.float64(4294967296.0) + alo.astype(jnp.float64)


# ---------------------------------------------------------------------------
# MurmurHash3 on pairs (bit-exact vs utils/hashing.py; see MurmurHash3.cpp)
# ---------------------------------------------------------------------------
_C1 = 0x87C37B91114253D5
_C2 = 0x4CF5AD432745937F
_F1 = 0xFF51AFD7ED558CCD
_F2 = 0xC4CEB9FE1A85EC53


def fmix64(klo, khi):
    klo, khi = xor(klo, khi, *shr(klo, khi, 33))
    klo, khi = mul_const(klo, khi, _F1)
    klo, khi = xor(klo, khi, *shr(klo, khi, 33))
    klo, khi = mul_const(klo, khi, _F2)
    klo, khi = xor(klo, khi, *shr(klo, khi, 33))
    return klo, khi


def murmur64_u64key(keylo, keyhi, seed: int = 42):
    """MurmurHash3_x64_128 low-u64 of an 8-byte key; pair-arithmetic version.

    Mirrors utils/hashing.py:murmur64_u64key (MurmurHash3.cpp:246-322, len=8).
    """
    slo, shi = split(seed)
    h1lo = jnp.broadcast_to(slo, keylo.shape).astype(jnp.uint32)
    h1hi = jnp.broadcast_to(shi, keylo.shape).astype(jnp.uint32)
    h2lo, h2hi = h1lo, h1hi

    k1lo, k1hi = mul_const(keylo, keyhi, _C1)
    k1lo, k1hi = rotl(k1lo, k1hi, 31)
    k1lo, k1hi = mul_const(k1lo, k1hi, _C2)
    h1lo, h1hi = xor(h1lo, h1hi, k1lo, k1hi)

    h1lo, h1hi = xor_const(h1lo, h1hi, 8)
    h2lo, h2hi = xor_const(h2lo, h2hi, 8)
    h1lo, h1hi = add(h1lo, h1hi, h2lo, h2hi)
    h2lo, h2hi = add(h2lo, h2hi, h1lo, h1hi)
    h1lo, h1hi = fmix64(h1lo, h1hi)
    h2lo, h2hi = fmix64(h2lo, h2hi)
    h1lo, h1hi = add(h1lo, h1hi, h2lo, h2hi)
    return h1lo, h1hi


def murmur64_u32key(keylo, seed: int = 42):
    """murmur64_u64key specialized for keys < 2^32 (keyhi == 0 as a trace
    literal, not a zero array): the ahi*blo cross terms and the h2-side
    init fold away at trace time. Bit-exact vs murmur64_u64key(key, 0) —
    pinned by tests/test_hashing.py. Saves ~10% of the plane ops in the
    sketch kernels, where the canonical l-mer value is a u32."""
    # k1 = (key, 0) * C1 ; with ahi = 0 the ahi*blo term vanishes
    c1lo, c1hi = split(_C1)
    k1lo, k1hi = mul32x32(keylo, c1lo)
    k1hi = k1hi + keylo * c1hi
    k1lo, k1hi = rotl(k1lo, k1hi, 31)
    k1lo, k1hi = mul_const(k1lo, k1hi, _C2)

    slo, shi = split(seed)
    # h1 = seed ^ k1 ^ 8 ; h2 = seed ^ 8 is a pure constant
    h1lo = k1lo ^ slo ^ np.uint32(8)
    h1hi = k1hi ^ shi
    h2lo_c = int(slo ^ np.uint32(8))
    h2hi_c = int(shi)
    h1lo, h1hi = add_const(h1lo, h1hi, (h2hi_c << 32) | h2lo_c)
    h2lo, h2hi = add_const(h1lo, h1hi, (h2hi_c << 32) | h2lo_c)
    h1lo, h1hi = fmix64(h1lo, h1hi)
    h2lo, h2hi = fmix64(h2lo, h2hi)
    h1lo, h1hi = add(h1lo, h1hi, h2lo, h2hi)
    return h1lo, h1hi


def minimizer_select_mask(keylo, keyhi, density: float):
    """Exact u64 threshold test matching the reference's double comparison.

    The reference compares ``double(hash) < double(float(density)) * 2^64``
    (Kmer.hpp:1358,1434). Rather than emulate float64 on TPU, we precompute
    the exact integer threshold T = ceil(bound) on the host: for a u64 hash
    h and a bound B (a double), ``double(h) < B`` iff ``h < T`` where T is
    the smallest u64 whose double conversion is >= B... computed exactly in
    host Python (arbitrary-precision) at trace time.
    """
    t = _exact_u64_threshold(density)
    tlo, thi = split(t)
    return lt(keylo, keyhi, tlo, thi)


def _exact_u64_threshold(density: float) -> int:
    """Smallest u64 t such that for all u64 h < t: double(h) < bound, and for
    all h >= t: double(h) >= bound — i.e. the integer cut making
    ``h < t`` equivalent to ``double(h) < bound``.
    """
    import numpy as np

    bound = float(np.float64(np.float32(density)) * np.float64(np.uint64(0xFFFFFFFFFFFFFFFF)))
    # double(h) is monotone non-decreasing in h, so the predicate
    # double(h) < bound is a prefix property; binary search the cut.
    lo_, hi_ = 0, 1 << 64
    while lo_ < hi_:
        mid = (lo_ + hi_) // 2
        if float(np.uint64(mid).astype(np.float64)) < bound:
            lo_ = mid + 1
        else:
            hi_ = mid
    return lo_


def murmur128_u32rows(rows, seed: int = 0):
    """MurmurHash3_x64_128_original over rows of u32 (pair-arithmetic).

    rows: (..., k) uint32. Returns (h1lo, h1hi, h2lo, h2hi) with shape (...,).
    Matches utils/hashing.py:murmur128_u32rows bit-for-bit. The loop over the
    row width k is unrolled at trace time (k is static).
    """
    rows = rows.astype(jnp.uint32)
    k = rows.shape[-1]
    length = 4 * k
    nblocks = k // 4
    rem = k % 4

    slo, shi = split(seed)
    shape = rows.shape[:-1]
    h1lo = jnp.broadcast_to(slo, shape).astype(jnp.uint32)
    h1hi = jnp.broadcast_to(shi, shape).astype(jnp.uint32)
    h2lo, h2hi = h1lo, h1hi

    for b in range(nblocks):
        k1lo, k1hi = rows[..., 4 * b], rows[..., 4 * b + 1]
        k2lo, k2hi = rows[..., 4 * b + 2], rows[..., 4 * b + 3]

        k1lo, k1hi = mul_const(k1lo, k1hi, _C1)
        k1lo, k1hi = rotl(k1lo, k1hi, 31)
        k1lo, k1hi = mul_const(k1lo, k1hi, _C2)
        h1lo, h1hi = xor(h1lo, h1hi, k1lo, k1hi)
        h1lo, h1hi = rotl(h1lo, h1hi, 27)
        h1lo, h1hi = add(h1lo, h1hi, h2lo, h2hi)
        h1lo, h1hi = mul_const(h1lo, h1hi, 5)
        h1lo, h1hi = add_const(h1lo, h1hi, 0x52DCE729)

        k2lo, k2hi = mul_const(k2lo, k2hi, _C2)
        k2lo, k2hi = rotl(k2lo, k2hi, 33)
        k2lo, k2hi = mul_const(k2lo, k2hi, _C1)
        h2lo, h2hi = xor(h2lo, h2hi, k2lo, k2hi)
        h2lo, h2hi = rotl(h2lo, h2hi, 31)
        h2lo, h2hi = add(h2lo, h2hi, h1lo, h1hi)
        h2lo, h2hi = mul_const(h2lo, h2hi, 5)
        h2lo, h2hi = add_const(h2lo, h2hi, 0x38495AB5)

    base = 4 * nblocks
    if rem == 3:
        k2lo, k2hi = rows[..., base + 2], jnp.zeros(shape, jnp.uint32)
        k2lo, k2hi = mul_const(k2lo, k2hi, _C2)
        k2lo, k2hi = rotl(k2lo, k2hi, 33)
        k2lo, k2hi = mul_const(k2lo, k2hi, _C1)
        h2lo, h2hi = xor(h2lo, h2hi, k2lo, k2hi)
    if rem >= 1:
        k1lo = rows[..., base]
        k1hi = rows[..., base + 1] if rem >= 2 else jnp.zeros(shape, jnp.uint32)
        k1lo, k1hi = mul_const(k1lo, k1hi, _C1)
        k1lo, k1hi = rotl(k1lo, k1hi, 31)
        k1lo, k1hi = mul_const(k1lo, k1hi, _C2)
        h1lo, h1hi = xor(h1lo, h1hi, k1lo, k1hi)

    h1lo, h1hi = xor_const(h1lo, h1hi, length)
    h2lo, h2hi = xor_const(h2lo, h2hi, length)
    h1lo, h1hi = add(h1lo, h1hi, h2lo, h2hi)
    h2lo, h2hi = add(h2lo, h2hi, h1lo, h1hi)
    h1lo, h1hi = fmix64(h1lo, h1hi)
    h2lo, h2hi = fmix64(h2lo, h2hi)
    h1lo, h1hi = add(h1lo, h1hi, h2lo, h2hi)
    h2lo, h2hi = add(h2lo, h2hi, h1lo, h1hi)
    return h1lo, h1hi, h2lo, h2hi
