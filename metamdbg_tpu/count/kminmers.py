"""k-min-mer extraction and counting (vectorized host path).

Method semantics (reference):
- a k-min-mer is a window of k consecutive minimizers of a read, canonicalized
  by lexicographic min(seq, reversed seq) (MDBG::getKminmers_complete #else
  branch, src/Commons.hpp:5284-5358; KmerVec::normalize src/Commons.hpp:886);
- counting groups identical k-min-mers; solid = abundance > 1 (and
  >= --min-abundance on the first pass) (KminmerCounter::dumpKminmer,
  src/graph/CreateMdbg.hpp:3862-3883);
- rescue: reads whose median solid abundance is <= 10 (exactly:
  double(float(median) * 0.1f) <= 1) contribute their abundance-1 k-min-mers
  at count 1, unless the whole read is abundance-1
  (RescueKminmerFunctor, src/graph/CreateMdbg.hpp:4562-4640).

The reference hash-shards k-min-mers to disk partitions and sorts each; we
sort the whole (N, k) u32 array at once (np.lexsort on the host, lax.sort
on the device) — identical grouping, no partition files. On several
devices the table is sharded by hash128 with all_to_all routing
(parallel/count_table.py).
"""

import numpy as np

from ..utils.hashing import murmur128_u32rows


def extract_kminmers(minimizers: np.ndarray, k: int):
    """All normalized k-windows of one read's minimizer array.

    Returns ((n-k+1, k) u32 normalized windows, (n-k+1,) bool is_reversed).
    """
    minimizers = np.asarray(minimizers, dtype=np.uint32)
    n = minimizers.shape[0]
    if n < k:
        return np.zeros((0, k), np.uint32), np.zeros(0, bool)
    windows = np.lib.stride_tricks.sliding_window_view(minimizers, k)
    return normalize_rows(windows)


def normalize_rows(windows: np.ndarray):
    """KmerVec::normalize over rows: lexicographic min(row, reversed row).

    Ties (palindromes) pick the reversed copy, matching normalize(bool&)
    (src/Commons.hpp:886-916: equality falls through to isReversed=true).
    Returns (normalized rows, is_reversed bool).
    """
    windows = np.ascontiguousarray(windows, dtype=np.uint32)
    rev = windows[:, ::-1]
    # first column where they differ decides; all-equal -> reversed
    neq = windows != rev
    first = np.where(neq.any(axis=1), neq.argmax(axis=1), windows.shape[1] - 1)
    r = np.arange(windows.shape[0])
    fw_val = windows[r, first]
    rv_val = rev[r, first]
    is_reversed = ~(fw_val < rv_val)  # equal -> reversed
    out = np.where(is_reversed[:, None], rev, windows)
    return np.ascontiguousarray(out), is_reversed


def batch_extract_kminmers(reads: list, k: int):
    """Concatenated normalized windows for many reads.

    Returns (rows (N,k) u32, read_ids (N,) int64, is_reversed (N,) bool,
    read_offsets) — rows in read order, windows in position order.

    One vectorized pass over the concatenated minimizer stream (windows
    crossing read boundaries masked out) instead of a per-read Python
    loop — at metagenome scale the loop dominated first-pass counting.
    """
    n_reads = len(reads)
    if n_reads == 0:
        return (np.zeros((0, k), np.uint32), np.zeros(0, np.int64),
                np.zeros(0, bool), np.zeros(1, np.int64))
    lens = np.fromiter((m.shape[0] for m in reads), np.int64, n_reads)
    cat = (np.concatenate(reads).astype(np.uint32, copy=False)
           if lens.sum() else np.zeros(0, np.uint32))
    starts = np.concatenate([[0], np.cumsum(lens)])
    if cat.shape[0] < k:
        return (np.zeros((0, k), np.uint32), np.zeros(0, np.int64),
                np.zeros(0, bool), np.zeros(n_reads + 1, np.int64))

    win = np.lib.stride_tricks.sliding_window_view(cat, k)  # (T-k+1, k)
    # read id of each stream position; window valid iff fully inside a read
    pos_read = np.repeat(np.arange(n_reads, dtype=np.int64), lens)
    valid = pos_read[:win.shape[0]] == pos_read[k - 1:]
    rows_raw = np.ascontiguousarray(win[valid])
    read_ids = pos_read[:win.shape[0]][valid]
    rows, revs = normalize_rows(rows_raw)

    counts = np.bincount(read_ids, minlength=n_reads) \
        if read_ids.shape[0] else np.zeros(n_reads, np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return rows, read_ids, revs, offsets


def sort_rows_lex(rows: np.ndarray) -> np.ndarray:
    """Indices sorting rows lexicographically (first column most significant)."""
    return np.lexsort(tuple(rows[:, j] for j in range(rows.shape[1] - 1, -1, -1)))


_DEVICE_COUNT_MIN_ROWS = 1 << 16


def count_unique_rows(rows: np.ndarray):
    """Group identical rows: returns (unique_rows sorted lex, counts).

    Large tables sort on device (kernels/count_jax.py, identical ordering);
    small ones stay on host where the dispatch overhead would dominate.
    Set METAMDBG_TPU_HOST_COUNT to force the host path.
    """
    if rows.shape[0] == 0:
        return rows, np.zeros(0, np.uint32)
    import os
    if (rows.shape[0] >= _DEVICE_COUNT_MIN_ROWS
            and not os.environ.get("METAMDBG_TPU_HOST_COUNT")):
        from ..utils import devwarm
        with devwarm.gate("device row counting", rows.shape[0]) as g:
            if g.device:
                from ..kernels.count_jax import count_unique_rows_device
                return count_unique_rows_device(np.ascontiguousarray(rows))
            return _count_unique_rows_host(rows)
    return _count_unique_rows_host(rows)


def _count_unique_rows_host(rows):
    order = sort_rows_lex(rows)
    s = rows[order]
    new_group = np.empty(s.shape[0], dtype=bool)
    new_group[0] = True
    np.not_equal(s[1:], s[:-1]).any(axis=1, out=new_group[1:])
    starts = np.flatnonzero(new_group)
    counts = np.diff(np.append(starts, s.shape[0])).astype(np.uint32)
    return s[starts], counts


def count_kminmers(reads: list, k: int, min_abundance: int = 0,
                   max_table_bytes: int | None = None):
    """First-pass counting + rescue. Returns a dict with:

    - 'solid_rows', 'solid_counts': abundance>1 (>= min_abundance) kminmers
    - 'rescued_rows': abundance-1 kminmers rescued at count 1 (deduplicated)
    - 'all_rows', 'all_counts': the node set of the graph (solid + rescued)
      with per-node abundance (rescued -> 1)

    Memory bound: when the full (N, k) u32 window table would exceed
    max_table_bytes (default METAMDBG_TPU_COUNT_TABLE_GB, 20 GB — the
    reference's disk-partition trigger, src/graph/CreateMdbg.cpp:223-226),
    counting streams read chunks through count_unique_rows and merges the
    per-chunk sorted tables, then replays a second chunked pass for the
    rescue — identical output, peak RAM ~ the unique table + one chunk.
    """
    if max_table_bytes is None:
        import os
        max_table_bytes = int(float(os.environ.get(
            "METAMDBG_TPU_COUNT_TABLE_GB", "20")) * (1 << 30))
    est = sum(max(0, m.shape[0] - k + 1) for m in reads) * k * 4
    if est > max_table_bytes:
        return _count_kminmers_bounded(reads, k, min_abundance,
                                       max_table_bytes)
    rows, read_ids, _, offsets = batch_extract_kminmers(reads, k)
    uniq, counts = count_unique_rows(rows)
    return _assemble_first_pass(rows, read_ids, offsets, uniq, counts, k,
                                min_abundance)


def _merge_counted(u1, c1, u2, c2):
    """Merge two lex-sorted unique-row tables, summing counts of equal rows."""
    if u1.shape[0] == 0:
        return u2, c2
    if u2.shape[0] == 0:
        return u1, c1
    rows = np.concatenate([u1, u2])
    cnt = np.concatenate([c1, c2]).astype(np.int64)
    order = sort_rows_lex(rows)
    s = rows[order]
    c = cnt[order]
    new_group = np.empty(s.shape[0], dtype=bool)
    new_group[0] = True
    np.not_equal(s[1:], s[:-1]).any(axis=1, out=new_group[1:])
    starts = np.flatnonzero(new_group)
    summed = np.add.reduceat(c, starts)
    return np.ascontiguousarray(s[starts]), summed.astype(np.uint32)


def _iter_read_chunks(reads, k: int, budget_rows: int):
    """Yield read-list chunks whose window totals stay under budget_rows."""
    chunk = []
    n_rows = 0
    for m in reads:
        w = max(0, m.shape[0] - k + 1)
        if chunk and n_rows + w > budget_rows:
            yield chunk
            chunk, n_rows = [], 0
        chunk.append(m)
        n_rows += w
    if chunk:
        yield chunk


def _count_kminmers_bounded(reads, k, min_abundance, max_table_bytes):
    import logging
    budget_rows = max(1, max_table_bytes // (k * 4) // 4)
    logging.getLogger("metamdbg_tpu").info(
        "bounded k-min-mer counting: table budget %.2f GB (%d rows/chunk)",
        max_table_bytes / (1 << 30), budget_rows)
    uniq = np.zeros((0, k), np.uint32)
    counts = np.zeros(0, np.uint32)
    for chunk in _iter_read_chunks(reads, k, budget_rows):
        rows, _, _, _ = batch_extract_kminmers(chunk, k)
        u, c = count_unique_rows(rows)
        uniq, counts = _merge_counted(uniq, counts, u, c)

    solid_mask = counts > 1
    if min_abundance > 1:
        solid_mask &= counts >= min_abundance
    solid_rows = uniq[solid_mask]
    solid_counts = counts[solid_mask]

    rescued_rows = np.zeros((0, k), np.uint32)
    if min_abundance <= 1:
        parts = []
        for chunk in _iter_read_chunks(reads, k, budget_rows):
            rows, read_ids, _, offsets = batch_extract_kminmers(chunk, k)
            if rows.shape[0] == 0:
                continue
            r = _rescue(rows, read_ids, offsets, solid_rows, solid_counts, k)
            if r.shape[0]:
                parts.append(r)
        if parts:
            rescued_rows, _ = count_unique_rows(np.concatenate(parts))

    if rescued_rows.shape[0]:
        all_rows = np.concatenate([solid_rows, rescued_rows])
        all_counts = np.concatenate(
            [solid_counts, np.ones(rescued_rows.shape[0], np.uint32)])
        order = sort_rows_lex(all_rows)
        all_rows, all_counts = all_rows[order], all_counts[order]
    else:
        all_rows, all_counts = solid_rows, solid_counts
    return dict(solid_rows=solid_rows, solid_counts=solid_counts,
                rescued_rows=rescued_rows, all_rows=all_rows,
                all_counts=all_counts)


def count_kminmers_mesh(mesh, reads: list, k: int, min_abundance: int = 0,
                        axis: str = "data"):
    """count_kminmers with the abundance table sharded over a device mesh.

    The heavy count (extract windows -> hash128 -> all_to_all route by
    `hash % num_shards` -> per-shard sort + segment-count) runs on the mesh
    (parallel/count_table.py), the device twin of the reference's
    hash-sharded disk partitions (src/graph/CreateMdbg.hpp:3714-3883). The
    host keeps only the unique-row materialization (needed for
    kminmerData_min.txt) and the rescue pass, and joins mesh counts back by
    128-bit hash.
    Byte-identical artifacts to the single-device path
    (tests/test_mesh_first_pass.py)."""
    rows, read_ids, _, offsets = batch_extract_kminmers(reads, k)
    if rows.shape[0] == 0:
        return count_kminmers(reads, k, min_abundance)
    from ..parallel.count_table import count_table

    from ..parallel.multihost import global_count_input

    ndev = mesh.shape[axis]
    n = len(reads)
    n_rows = ((max(n, 1) + ndev - 1) // ndev) * ndev
    width = max(max((r.shape[0] for r in reads), default=k), k)
    mins = np.zeros((n_rows, width), np.uint32)
    lens = np.zeros(n_rows, np.int32)
    for i, m in enumerate(reads):
        mins[i, :m.shape[0]] = m
        lens[i] = m.shape[0]
    mins_g, lens_g = global_count_input(mesh, mins, lens, axis=axis)
    keys, key_counts = count_table(mesh, mins_g, lens_g, k, axis=axis)

    uniq, _ = count_unique_rows(rows)
    qkey = np.stack(murmur128_u32rows(uniq), axis=1)
    idx = _searchsorted_pairs(keys, qkey)
    idx_c = np.minimum(idx, keys.shape[0] - 1)
    if not (keys[idx_c] == qkey).all():
        raise AssertionError("mesh count table is missing k-min-mers "
                             "present on host — routing bug")
    counts = key_counts[idx_c]
    return _assemble_first_pass(rows, read_ids, offsets, uniq, counts, k,
                                min_abundance)


def _assemble_first_pass(rows, read_ids, offsets, uniq, counts, k,
                         min_abundance):
    solid_mask = counts > 1
    if min_abundance > 1:
        solid_mask &= counts >= min_abundance
    solid_rows = uniq[solid_mask]
    solid_counts = counts[solid_mask]

    rescued_rows = np.zeros((0, k), np.uint32)
    if min_abundance <= 1 and rows.shape[0] > 0:
        rescued_rows = _rescue(rows, read_ids, offsets, solid_rows, solid_counts, k)

    if rescued_rows.shape[0]:
        all_rows = np.concatenate([solid_rows, rescued_rows])
        all_counts = np.concatenate(
            [solid_counts, np.ones(rescued_rows.shape[0], np.uint32)])
        order = sort_rows_lex(all_rows)
        all_rows, all_counts = all_rows[order], all_counts[order]
    else:
        all_rows, all_counts = solid_rows, solid_counts

    return dict(solid_rows=solid_rows, solid_counts=solid_counts,
                rescued_rows=rescued_rows, all_rows=all_rows,
                all_counts=all_counts)


def _lookup_rows(query: np.ndarray, table: np.ndarray, values: np.ndarray,
                 default):
    """For each query row, value of the matching table row (lex-sorted table)."""
    if query.shape[0] == 0 or table.shape[0] == 0:
        dt = np.asarray(values).dtype if np.asarray(values).size else np.uint32
        return (np.full(query.shape[0], default, dtype=dt),
                np.zeros(query.shape[0], dtype=bool))
    # compare via 128-bit hashes (collision probability ~2^-128)
    qh = murmur128_u32rows(query)
    th = murmur128_u32rows(table)
    qkey = np.stack(qh, axis=1)
    tkey = np.stack(th, axis=1)
    torder = np.lexsort((tkey[:, 1], tkey[:, 0]))
    tkey_s = tkey[torder]
    vals_s = values[torder]
    idx = _searchsorted_pairs(tkey_s, qkey)
    idx_c = np.minimum(idx, tkey_s.shape[0] - 1)
    hit = (tkey_s[idx_c] == qkey).all(axis=1) & (idx < tkey_s.shape[0])
    out = np.full(query.shape[0], default, dtype=vals_s.dtype)
    out[hit] = vals_s[idx_c[hit]]
    return out, hit


def _searchsorted_pairs(sorted_pairs: np.ndarray, queries: np.ndarray):
    """searchsorted over (N,2) u64 keys ordered by (col0, col1)."""
    # two-level search: col0 range, then col1 within the matching segment.
    # col0 segments of length 1 (the overwhelmingly common case — col0 is a
    # murmur128 half, so repeats only come from identical keys) resolve with
    # one vectorized compare; only multi-row segments fall back to a loop.
    lo = np.searchsorted(sorted_pairs[:, 0], queries[:, 0], side="left")
    hi = np.searchsorted(sorted_pairs[:, 0], queries[:, 0], side="right")
    out = lo.copy()
    seg1 = hi - lo == 1
    if seg1.any():
        i1 = np.flatnonzero(seg1)
        out[i1] = lo[i1] + (sorted_pairs[lo[i1], 1] < queries[i1, 1])
    multi = hi - lo > 1
    if multi.any():
        for i in np.flatnonzero(multi).tolist():
            seg = sorted_pairs[lo[i]:hi[i], 1]
            out[i] = lo[i] + np.searchsorted(seg, queries[i, 1], side="left")
    return out


def _rescue(rows, read_ids, offsets, solid_rows, solid_counts, k):
    """RescueKminmerFunctor semantics (src/graph/CreateMdbg.hpp:4579-4637),
    vectorized over reads: per-read medians come from one global
    sort-within-read, the keep decision is a gather, and weak windows are
    selected with one boolean mask."""
    abundances, hit = _lookup_rows(rows, solid_rows,
                                   solid_counts.astype(np.uint32), 1)
    nreads = offsets.shape[0] - 1
    if rows.shape[0] == 0 or nreads == 0:
        return np.zeros((0, k), np.uint32)
    offsets = np.asarray(offsets, np.int64)
    seg_len = np.diff(offsets)
    nonempty = seg_len > 0

    # any solid window per read, via prefix sums (exact on empty segments)
    csum = np.concatenate([[0], np.cumsum(hit.astype(np.int64))])
    any_hit = (csum[offsets[1:]] - csum[offsets[:-1]]) > 0

    # per-read sorted abundances: one lexsort keyed (read, abundance)
    order = np.lexsort((abundances, read_ids))
    s = abundances[order].astype(np.int64)
    half = seg_len // 2
    lo_idx = np.where(nonempty, offsets[:-1] + np.maximum(half - 1, 0), 0)
    mid_idx = np.where(nonempty, offsets[:-1] + half, 0)
    lo_idx = np.minimum(lo_idx, s.shape[0] - 1)
    mid_idx = np.minimum(mid_idx, s.shape[0] - 1)
    even = (seg_len % 2 == 0) & nonempty
    # u32 integer mean (Utils::compute_median, Commons.hpp:2982)
    med = np.where(even, ((s[lo_idx] + s[mid_idx]) & 0xFFFFFFFF) // 2,
                   s[mid_idx])
    cutoff = (med.astype(np.uint32).astype(np.float32)
              * np.float32(0.1)).astype(np.float64)
    keep_read = any_hit & (cutoff <= 1.0)

    weak_mask = keep_read[read_ids] & ~hit
    cat = rows[weak_mask]
    if cat.shape[0] == 0:
        return np.zeros((0, k), np.uint32)
    uniq, _ = count_unique_rows(cat)
    return uniq
