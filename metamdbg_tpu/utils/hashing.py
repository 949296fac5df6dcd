"""Bit-exact vectorized MurmurHash3 (host / numpy path).

The reference method's determinism hinges on two hash functions
(src/utils/MurmurHash3.cpp):

- ``MurmurHash3_x64_128(key, len=8, seed=42) -> low u64`` — minimizer
  selection threshold hash (src/utils/kmer/Kmer.hpp:1421,1434).
- ``MurmurHash3_x64_128_original(key, len=4*k, seed=0) -> (h1, h2)`` —
  128-bit k-min-mer identity hash (src/Commons.hpp:956-969), result packed
  as ``(h1 << 64) | h2``.

Both are implemented here as vectorized numpy over u64 arrays, matching the
C++ bit-for-bit (validated in tests/test_hashing.py against an independent
scalar model). The device path (u32-pair arithmetic, no 64-bit ints)
lives in metamdbg_tpu/utils/u64pair.py and must agree exactly.
"""

import numpy as np

_U64 = np.uint64
_C1 = _U64(0x87C37B91114253D5)
_C2 = _U64(0x4CF5AD432745937F)
_F1 = _U64(0xFF51AFD7ED558CCD)
_F2 = _U64(0xC4CEB9FE1A85EC53)

_old_err = None


def _rotl64(x: np.ndarray, r: int) -> np.ndarray:
    r = _U64(r)
    return (x << r) | (x >> (_U64(64) - r))


def _fmix64(k: np.ndarray) -> np.ndarray:
    k = k ^ (k >> _U64(33))
    k = k * _F1
    k = k ^ (k >> _U64(33))
    k = k * _F2
    k = k ^ (k >> _U64(33))
    return k


def murmur64_u64key(keys: np.ndarray, seed: int = 42) -> np.ndarray:
    """MurmurHash3_x64_128 of an 8-byte little-endian key; returns low 64 bits.

    Vectorized over an array of u64 keys. Matches MurmurHash3.cpp:246-322 for
    len=8: zero blocks, tail=8 bytes (k1 = key, k2 = 0 untouched).
    """
    keys = np.asarray(keys, dtype=_U64)
    with np.errstate(over="ignore"):
        h1 = np.full_like(keys, _U64(seed))
        h2 = np.full_like(keys, _U64(seed))

        k1 = keys * _C1
        k1 = _rotl64(k1, 31)
        k1 = k1 * _C2
        h1 = h1 ^ k1

        h1 = h1 ^ _U64(8)
        h2 = h2 ^ _U64(8)
        h1 = h1 + h2
        h2 = h2 + h1
        h1 = _fmix64(h1)
        h2 = _fmix64(h2)
        h1 = h1 + h2
        # h2 += h1 dropped: only h1 is returned (MurmurHash3.cpp:321)
    return h1


def murmur128_u32rows(rows: np.ndarray, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """MurmurHash3_x64_128_original over rows of u32 values (little-endian bytes).

    ``rows`` is (N, k) u32; each row is hashed as a byte string of length 4*k
    (exactly KmerVec::hash128, src/Commons.hpp:956-969). Returns (h1, h2) u64
    arrays; the reference packs them as ``(h1 << 64) | h2``.

    Vectorized across rows; the block loop over k is a short Python loop
    (k/4 iterations), each step full-width numpy.
    """
    rows = np.asarray(rows, dtype=np.uint32)
    if rows.ndim == 1:
        rows = rows[None, :]
    n, k = rows.shape
    if seed == 0 and n and k:
        # native fast path (bit-identical; the numpy path below is the
        # oracle): per-call numpy overhead on small row sets dominated the
        # multi-k ladder at small scales
        from ..sketch import native_sketch
        res = native_sketch.row_hash_batch(rows)
        if res is not None:
            return res
    length = 4 * k
    nblocks = length // 16          # = k // 4
    rem = k % 4                     # leftover u32s -> tail of 4*rem bytes

    r64 = rows.astype(_U64)
    with np.errstate(over="ignore"):
        h1 = np.full(n, _U64(seed))
        h2 = np.full(n, _U64(seed))

        for b in range(nblocks):
            k1 = r64[:, 4 * b] | (r64[:, 4 * b + 1] << _U64(32))
            k2 = r64[:, 4 * b + 2] | (r64[:, 4 * b + 3] << _U64(32))

            k1 = k1 * _C1
            k1 = _rotl64(k1, 31)
            k1 = k1 * _C2
            h1 = h1 ^ k1
            h1 = _rotl64(h1, 27)
            h1 = h1 + h2
            h1 = h1 * _U64(5) + _U64(0x52DCE729)

            k2 = k2 * _C2
            k2 = _rotl64(k2, 33)
            k2 = k2 * _C1
            h2 = h2 ^ k2
            h2 = _rotl64(h2, 31)
            h2 = h2 + h1
            h2 = h2 * _U64(5) + _U64(0x38495AB5)

        base = 4 * nblocks
        if rem == 3:                # len&15 == 12: k2 = tail[8..11], k1 = tail[0..7]
            k2 = r64[:, base + 2]
            k2 = k2 * _C2
            k2 = _rotl64(k2, 33)
            k2 = k2 * _C1
            h2 = h2 ^ k2
        if rem >= 1:
            k1 = r64[:, base]
            if rem >= 2:
                k1 = k1 | (r64[:, base + 1] << _U64(32))
            k1 = k1 * _C1
            k1 = _rotl64(k1, 31)
            k1 = k1 * _C2
            h1 = h1 ^ k1

        h1 = h1 ^ _U64(length)
        h2 = h2 ^ _U64(length)
        h1 = h1 + h2
        h2 = h2 + h1
        h1 = _fmix64(h1)
        h2 = _fmix64(h2)
        h1 = h1 + h2
        h2 = h2 + h1
    return h1, h2


_M64 = (1 << 64) - 1
_iC1 = 0x87C37B91114253D5
_iC2 = 0x4CF5AD432745937F
_iF1 = 0xFF51AFD7ED558CCD
_iF2 = 0xC4CEB9FE1A85EC53


def _irotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _ifmix(k: int) -> int:
    k ^= k >> 33
    k = (k * _iF1) & _M64
    k ^= k >> 33
    k = (k * _iF2) & _M64
    k ^= k >> 33
    return k


def murmur128_u32row_scalar(vals, seed: int = 0) -> tuple[int, int]:
    """Scalar-int twin of murmur128_u32rows for ONE row (a python sequence
    of u32 values) — ~50x cheaper than the numpy path at batch size 1.
    Bit-identical (tests/test_hashing.py)."""
    k = len(vals)
    length = 4 * k
    nblocks = k // 4
    rem = k % 4
    h1 = h2 = seed
    for b in range(nblocks):
        j = 4 * b
        k1 = vals[j] | (vals[j + 1] << 32)
        k2 = vals[j + 2] | (vals[j + 3] << 32)
        k1 = (k1 * _iC1) & _M64
        k1 = _irotl(k1, 31)
        k1 = (k1 * _iC2) & _M64
        h1 ^= k1
        h1 = _irotl(h1, 27)
        h1 = (h1 + h2) & _M64
        h1 = (h1 * 5 + 0x52DCE729) & _M64
        k2 = (k2 * _iC2) & _M64
        k2 = _irotl(k2, 33)
        k2 = (k2 * _iC1) & _M64
        h2 ^= k2
        h2 = _irotl(h2, 31)
        h2 = (h2 + h1) & _M64
        h2 = (h2 * 5 + 0x38495AB5) & _M64
    base = 4 * nblocks
    if rem == 3:
        k2 = (vals[base + 2] * _iC2) & _M64
        k2 = _irotl(k2, 33)
        k2 = (k2 * _iC1) & _M64
        h2 ^= k2
    if rem >= 1:
        k1 = vals[base]
        if rem >= 2:
            k1 |= vals[base + 1] << 32
        k1 = (k1 * _iC1) & _M64
        k1 = _irotl(k1, 31)
        k1 = (k1 * _iC2) & _M64
        h1 ^= k1
    h1 ^= length
    h2 ^= length
    h1 = (h1 + h2) & _M64
    h2 = (h2 + h1) & _M64
    h1 = _ifmix(h1)
    h2 = _ifmix(h2)
    h1 = (h1 + h2) & _M64
    h2 = (h2 + h1) & _M64
    return h1, h2


def kminmer_hash128(rows: np.ndarray) -> np.ndarray:
    """128-bit k-min-mer identity hash, packed into structured (hi, lo) u64 pair.

    Reference packs (h1 << 64) | h2 (src/Commons.hpp:965-967); we return a
    (N, 2) array with [:, 0] = h1 (high) and [:, 1] = h2 (low) so that
    lexicographic order over rows equals the reference's u128 order.
    """
    h1, h2 = murmur128_u32rows(rows, seed=0)
    return np.stack([h1, h2], axis=1)


def minimizer_is_selected(kmer_values: np.ndarray, density: float) -> np.ndarray:
    """Universe-hash minimizer test (src/utils/kmer/Kmer.hpp:1421,1434).

    ``double(hash) < density * double(UINT64_MAX)`` with C double semantics:
    the u64 hash converts to the nearest double before comparison, and the
    density is stored as float upstream (Params::_minimizerDensity_assembly)
    before widening to double in the bound product (Kmer.hpp:1352,1358).
    """
    bound = np.float64(np.float32(density)) * np.float64(np.uint64(0xFFFFFFFFFFFFFFFF))
    h = murmur64_u64key(kmer_values, seed=42)
    return h.astype(np.float64) < bound
