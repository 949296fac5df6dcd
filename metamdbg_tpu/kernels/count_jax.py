"""Device k-min-mer counting: lexicographic sort + run-length grouping.

Device twin of count/kminmers.count_unique_rows — replaces the reference's
partitioned disk sort + run-length count (KminmerCounter,
src/graph/CreateMdbg.hpp:3744-3851) with one device sort over the whole
(N, k) u32 table. `jax.lax.sort(num_keys=k)` gives exactly np.lexsort's
ascending lexicographic order, so grouping is bit-identical to the host
path (tests/test_device_count.py).

Padding rows are all-0xFFFFFFFF and sort to the end; the host drops them
(a real k-min-mer can never be all-ones: minimizer values are < 2^(2l)).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

_PAD = np.uint32(0xFFFFFFFF)


@functools.partial(jax.jit, static_argnames=("k",))
def _sort_rows(cols, k: int):
    sorted_cols = jax.lax.sort(cols, num_keys=k, is_stable=False)
    boundary = jnp.zeros(cols[0].shape[0], bool).at[0].set(True)
    for c in sorted_cols:
        boundary = boundary.at[1:].max(c[1:] != c[:-1])
    return sorted_cols, boundary


def _pad_size(n: int) -> int:
    p = 1024
    while p < n:
        p <<= 1
    return p


def count_unique_rows_device(rows: np.ndarray):
    """Group identical rows on device: (unique rows lex-sorted, counts)."""
    n, k = rows.shape
    if n == 0:
        return rows, np.zeros(0, np.uint32)
    p = _pad_size(n)
    cols = []
    for j in range(k):
        c = np.full(p, _PAD, np.uint32)
        c[:n] = rows[:, j]
        cols.append(c)
    sorted_cols, boundary = _sort_rows(tuple(cols), k)
    s = np.stack([np.asarray(c)[:n] for c in sorted_cols], axis=1)
    starts = np.flatnonzero(np.asarray(boundary)[:n])
    counts = np.diff(np.append(starts, n)).astype(np.uint32)
    return s[starts], counts
