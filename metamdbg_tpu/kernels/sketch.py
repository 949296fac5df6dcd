"""Device batch sketching: reads -> minimizer masks, fully in JAX.

This is the device twin of sketch/{kmers,minimizers}.py: identical math
(bit-exact canonical k-mers and MurmurHash3 threshold selection) expressed
over padded batches of base codes and jit-compiled by XLA into elementwise
fusions. 64-bit values are (lo, hi) uint32 pairs throughout
(utils/u64pair.py), so the kernel needs no 64-bit integer arithmetic.

Layout: a batch is (codes u8[N, L], length i32[N]) with padding after each
read's length. All positions compute; masks make padding inert. The
selection mask + values + directions come back; compaction into per-read
minimizer lists happens host-side (cheap: ~density * bases elements).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import u64pair


def encode_reads(seqs: list, pad_to: int | None = None):
    """Host helper: ascii reads -> (codes u8[N, L], lengths i32[N])."""
    n = len(seqs)
    if pad_to is None:
        pad_to = max((len(s) for s in seqs), default=0)
    codes = np.zeros((n, pad_to), np.uint8)
    lengths = np.zeros(n, np.int32)
    for i, s in enumerate(seqs):
        b = np.frombuffer(s, np.uint8) if isinstance(s, (bytes, bytearray)) \
            else np.asarray(s, np.uint8)
        codes[i, :b.shape[0]] = (b >> 1) & 3
        # bad-char flag folded into code 4 (forces window invalid)
        bad = ((b >> 3) & 1).astype(bool)
        codes[i, :b.shape[0]][bad] = 4
        lengths[i] = b.shape[0]
    return codes, lengths


@functools.partial(jax.jit, static_argnames=("l", "density", "trim"))
def sketch_batch(codes: jax.Array, lengths: jax.Array, l: int, density: float,
                 trim: int = 1):
    """Minimizer selection over a padded batch.

    codes: u8[N, L] base codes (0..3; >=4 marks bad/invalid bases)
    Returns dict of u32[N, L-l+1] canonical kmer values (truncated to u32,
    valid for l <= 16), bool select mask, u8 directions.
    ``trim=0`` disables the per-row end trim — used by the tile-packed path
    (sketch/batch.py) where rows hold concatenated reads and the 1-window
    read-end trim is applied host-side on read-local indices.
    """
    n, L = codes.shape
    nk = L - l + 1
    c = codes.astype(jnp.uint32)
    is_bad = c >= 4
    base = jnp.where(is_bad, 0, c)
    comp = base ^ 2  # A<->T C<->G in (ascii>>1)&3 encoding

    fwd = jnp.zeros((n, nk), jnp.uint32)
    rev = jnp.zeros((n, nk), jnp.uint32)
    invalid = jnp.zeros((n, nk), bool)
    for j in range(l):
        fwd = fwd | (base[:, j:j + nk] << (2 * (l - 1 - j)))
        rev = rev | (comp[:, j:j + nk] << (2 * j))
        invalid = invalid | is_bad[:, j:j + nk]

    choice_rev = ~(fwd < rev)                      # ties -> reverse
    values = jnp.where(choice_rev, rev, fwd)
    directions = choice_rev.astype(jnp.uint8)

    # murmur64(value zero-extended to u64, seed 42) < density threshold
    hlo, hhi = u64pair.murmur64_u64key(values, jnp.zeros_like(values), seed=42)
    selected = u64pair.minimizer_select_mask(hlo, hhi, density)

    pos = jax.lax.broadcasted_iota(jnp.int32, (n, nk), 1)
    in_read = pos < (lengths[:, None] - l + 1)
    selected = selected & ~invalid & in_read
    if trim:  # _trimBps = 1
        selected = selected & (pos >= trim) & (pos < (lengths[:, None] - l
                                                      - trim + 1))

    return {"values": values, "selected": selected, "directions": directions}


@functools.partial(jax.jit, static_argnames=("l", "density", "cap"))
def sketch_batch_compact(codes: jax.Array, lengths: jax.Array, l: int,
                         density: float, cap: int):
    """sketch_batch + on-device compaction: only the selected entries come
    back to the host.

    The full (N, L) masks never leave the device — each row's selected
    positions are sorted to the front (lax.sort keyed by masked position) and
    the first ``cap`` columns are returned. ``counts`` reports the true
    per-row selection count; rows with counts > cap must be redone via the
    uncompacted path (callers: sketch/batch.py). Cuts device-to-host
    transfer by ~1/density.
    """
    return _sketch_compact_core(codes, lengths, l, density, cap)


def _sketch_compact_core(codes, lengths, l: int, density: float, cap: int,
                         trim: int = 1):
    n, L = codes.shape
    nk = L - l + 1
    res = sketch_batch.__wrapped__(codes, lengths, l, density, trim)
    selected = res["selected"]
    pos = jax.lax.broadcasted_iota(jnp.int32, (n, nk), 1)
    key = jnp.where(selected, pos, jnp.int32(nk))
    key_s, vals_s, dirs_s = jax.lax.sort(
        (key, res["values"], res["directions"]), num_keys=1, dimension=1,
        is_stable=True)
    counts = selected.sum(axis=1, dtype=jnp.int32)
    return {"positions": key_s[:, :cap], "values": vals_s[:, :cap],
            "directions": dirs_s[:, :cap], "counts": counts}


def pack_codes(codes: np.ndarray):
    """Host: (N, L) u8 base codes (0..3, >=4 bad) -> 2-bit packed codes
    (N, L/4) + bad bitmap (N, L/8). L must be a multiple of 8 (the batcher
    pads to >=256 powers of two). Cuts host-to-device transfer 2.7x."""
    n, L = codes.shape
    bad = codes >= 4
    c = np.where(bad, 0, codes).astype(np.uint8)
    c = c.reshape(n, L // 4, 4)
    packed = (c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4)
              | (c[:, :, 3] << 6))
    bad_packed = np.packbits(bad, axis=1, bitorder="little")
    return packed, bad_packed


@functools.partial(jax.jit, static_argnames=("l", "density", "cap"))
def sketch_batch_compact_packed(packed: jax.Array, bad_packed: jax.Array,
                                lengths: jax.Array, l: int, density: float,
                                cap: int):
    """sketch_batch_compact on 2-bit packed input (see pack_codes)."""
    n, Lq = packed.shape
    L = Lq * 4
    p = packed.astype(jnp.uint8)
    codes = jnp.stack([(p >> (2 * j)) & 3 for j in range(4)],
                      axis=2).reshape(n, L)
    b = bad_packed.astype(jnp.uint8)
    bad = jnp.stack([(b >> j) & 1 for j in range(8)],
                    axis=2).reshape(n, L).astype(bool)
    codes = jnp.where(bad, jnp.uint8(4), codes)
    # rows hold concatenated reads: no row trim (host applies read trim)
    return _sketch_compact_core(codes, lengths, l, density, cap, trim=0)


def compact_cap(nk: int, density: float) -> int:
    """Static per-row capacity: ~2.5x the expected selection count, rounded
    up to a multiple of 128. Overflow rows (repeat-dense content) are
    detected via ``counts`` and recomputed host-side — the capacity trades
    device-to-host bytes against rare host recomputes."""
    cap = int(nk * density * 2.5) + 32
    cap = (cap + 127) // 128 * 128
    return min(nk, cap)


def extract_minimizers(result, lengths) -> list:
    """Host-side compaction of a sketch_batch result into per-read arrays."""
    values = np.asarray(result["values"])
    selected = np.asarray(result["selected"])
    directions = np.asarray(result["directions"])
    out = []
    for i in range(values.shape[0]):
        pos = np.flatnonzero(selected[i])
        out.append((values[i, pos].astype(np.uint32), pos.astype(np.uint32),
                    directions[i, pos]))
    return out
