"""All-vs-all minimizer-pair read mapping (correction stage 1).

Mirrors ReadMapper (src/readSelection/ReadMapper.hpp:9-1428):

- reads are chunked by total minimizer count (ReadMapper.hpp:191-193,
  Commons.hpp:7682-7686); each chunk's minimizer *pairs* (2-min-mers packed
  to u64, center position = (pos[i]+pos[i+1])/2) form a sorted table;
- every read is matched against the table (ReadMapper.hpp:668-845): anchors
  grouped per target read, chained with the banded DP (band =
  2500*density_correction, w=20), chain score = nbMatches - nbDifferences;
- per matched position of the read, the best `usedCoverage` (20) target reads
  are kept (score desc, read index asc; ReadMapper.hpp:1233-1313), the union
  over positions is the read's aligned set;
- chunk results merge by recomputing scores from the match positions
  (ReadMapper.hpp:218-443) and re-selecting, then the final per-read sorted
  aligned-read lists are written to readAlignmentsLowDensity.bin
  ({u32 ref, u32 n, u32 query[n]}, ReadMapper.hpp:1391-1426).

Device paths: on several devices the table join runs sharded with
all_to_all (parallel/pair_join.py, same machinery as the sharded count
table); the per-pair banded chaining DP runs batched on the device
(kernels/chain_jax.py, fixed band, lax.scan over anchors).
"""

import os
import struct

import numpy as np

from ..basespace.chaining import normalized_pairs
from .chainer import chain_dp, backtrack

USED_COVERAGE_FOR_CORRECTION = 20   # ReadCorrection.hpp:1728
MIN_READ_MINIMIZERS = 10            # Commons.hpp:2190 isReadTooShort

# anchor-count buckets for the batched device chain DP
_CHAIN_BUCKETS = (64, 256, 1024, 4096)
_DEVICE_STATE: dict = {}


def _device_enabled() -> bool:
    if "on" not in _DEVICE_STATE:
        _DEVICE_STATE["on"] = \
            os.environ.get("METAMDBG_DEVICE_CHAIN", "1") != "0"
    return _DEVICE_STATE["on"]


def _chain_groups_device(groups, max_band):
    """Batched device chaining of many anchor groups. groups: list of
    (ref_pos, q_pos, is_rev, q_idx) arrays. Returns per-group
    (score, positions) | None, same as chain_read_pair."""
    from ..kernels.chain_jax import chain_dp_device

    out = [None] * len(groups)
    by_bucket: dict = {}
    for gi, (rp, qp, rv, qi) in enumerate(groups):
        n = rp.shape[0]
        bucket = next((b for b in _CHAIN_BUCKETS if n <= b), None)
        if bucket is None:  # enormous group: host path
            out[gi] = chain_read_pair(rp, qp, rv, qi, max_band)
            continue
        by_bucket.setdefault(bucket, []).append(gi)

    for bucket, idxs in by_bucket.items():
        P = len(idxs)
        ref_pos = np.zeros((P, bucket), np.int64)
        q_pos = np.zeros((P, bucket), np.int64)
        is_rev = np.zeros((P, bucket), bool)
        n_anchors = np.zeros(P, np.int64)
        for r, gi in enumerate(idxs):
            rp, qp, rv, qi = groups[gi]
            n = rp.shape[0]
            ref_pos[r, :n] = rp
            q_pos[r, :n] = qp
            is_rev[r, :n] = rv
            n_anchors[r] = n
        scores, parents, best = chain_dp_device(ref_pos, q_pos, is_rev,
                                                n_anchors, max_band)
        for r, gi in enumerate(idxs):
            b = int(best[r])
            if b < 0:
                continue
            interval = []
            idx = b
            while idx != -1:
                interval.append(idx)
                idx = int(parents[r, idx])
            interval.reverse()
            if len(interval) < 3:
                continue
            qi = groups[gi][3]
            qidx = [int(qi[t]) for t in interval]
            first_q, last_q = qidx[-1], qidx[0]
            nb_matches = len(interval)
            if first_q > last_q:
                diff_q = (first_q - last_q + 1) - nb_matches
            else:
                diff_q = (last_q - first_q + 1) - nb_matches
            out[gi] = (nb_matches - diff_q,
                       np.asarray(sorted(qidx), np.uint32))
    return out


def read_pairs(read):
    """(packed u64 pairs, center positions u32, is_reversed bool) of a read
    (ReadMapper.hpp:475-499)."""
    packed, is_rev = normalized_pairs(read.minimizers)
    if packed.shape[0] == 0:
        return packed, np.zeros(0, np.int64), is_rev
    pos = read.positions.astype(np.int64)
    centers = (pos[:-1] + pos[1:]) // 2
    return packed, centers, is_rev


def chain_read_pair(ref_pos, q_pos, is_rev, q_idx, max_band):
    """ReadMapper's chainAnchors (ReadMapper.hpp:887-1087): returns
    (score i32, match_positions ascending) or None.

    Anchors must be sorted by (refPos, queryPos) already. q_idx are the
    query pair indexes. Needs >= 3 chained anchors.
    """
    scores, parents, best_index = chain_dp(ref_pos, q_pos, is_rev, max_band)
    if best_index < 0:
        return None
    interval = backtrack(parents, best_index)
    if len(interval) < 3:
        return None

    # interval is root->best; the reference reverses to best->root, then
    # reverses queryAnchorPositions again iff first.qIdx > last.qIdx —
    # net effect: match positions in ascending query-index order
    qidx = [int(q_idx[t]) for t in interval]
    first_q, last_q = qidx[-1], qidx[0]   # best, root in reference terms
    nb_matches = len(interval)
    if first_q > last_q:
        diff_q = (first_q - last_q + 1) - nb_matches
    else:
        diff_q = (last_q - first_q + 1) - nb_matches
    positions = sorted(qidx)
    score = nb_matches - diff_q
    return score, np.asarray(positions, np.uint32)


def _select_union(n_positions: int, entries, used_coverage: int):
    """Per-position bounded best lists -> union of kept target reads.

    entries: list of (target_read, score, positions u32[]). Selection per
    position = top `used_coverage` by (score desc, target asc), multiset
    semantics (ReadMapper.hpp:1259-1310).
    """
    if not entries:
        return []
    n_e = len(entries)
    counts = np.fromiter((e[2].shape[0] for e in entries), np.int64, n_e)
    pos = np.concatenate([e[2] for e in entries]).astype(np.int64)
    score = np.repeat(np.fromiter((e[1] for e in entries), np.int64, n_e),
                      counts)
    tgt = np.repeat(np.fromiter((e[0] for e in entries), np.int64, n_e),
                    counts)
    order = np.lexsort((tgt, -score, pos))
    pos_s = pos[order]
    tgt_s = tgt[order]
    # rank within each position group
    boundaries = np.flatnonzero(np.diff(pos_s)) + 1
    starts = np.concatenate([[0], boundaries])
    idx = np.arange(pos_s.shape[0])
    group_start = np.repeat(starts, np.diff(np.concatenate([starts, [pos_s.shape[0]]])))
    rank = idx - group_start
    keep = rank < used_coverage
    return np.unique(tgt_s[keep]).tolist()


class ReadMapperResult:
    def __init__(self):
        # per read: list of (target_read, match_positions) surviving chunk
        # selection; merged at the end
        self.per_read: dict[int, list] = {}


def run_read_mapper(reads, nb_minimizers_per_chunk: int, max_chaining_band: int,
                    used_coverage: int = USED_COVERAGE_FOR_CORRECTION,
                    alignment_path: str | None = None, mesh=None):
    """reads: list of io.records.MinimizerRead (read_data_init.txt order).

    Returns dict read_index -> np.ndarray of aligned read indexes (sorted).
    With `mesh` the pair-table join runs sharded over the device mesh
    (parallel/pair_join.py) — byte-identical output
    (tests/test_pair_join.py).
    """
    pair_data = [read_pairs(r) for r in reads]
    sizes = [r.minimizers.shape[0] for r in reads]

    # chunk boundaries (Commons.hpp:7682-7686): flush before adding a read
    # when the accumulated minimizer count has reached the cap
    chunks = []
    cur = []
    cur_size = 0
    for i, n in enumerate(sizes):
        if cur and cur_size >= nb_minimizers_per_chunk:
            chunks.append(cur)
            cur = []
            cur_size = 0
        cur.append(i)
        cur_size += n
    if cur:
        chunks.append(cur)

    accum: dict[int, list] = {}
    for chunk in chunks:
        _process_chunk(chunk, reads, pair_data, max_chaining_band,
                       used_coverage, accum, mesh=mesh)

    # merge phase: recompute scores from match positions, re-select
    result: dict[int, np.ndarray] = {}
    for read_index in sorted(accum.keys()):
        entries = []
        for (tgt, positions) in accum[read_index]:
            score = _score_from_positions(positions)
            entries.append((tgt, score, positions))
        n_pos = sizes[read_index]
        selected = _select_union(n_pos, entries, used_coverage)
        if selected:
            result[read_index] = np.asarray(selected, np.uint32)

    if alignment_path is not None:
        with open(alignment_path, "wb") as f:
            for read_index in sorted(result.keys()):
                sel = result[read_index]
                f.write(struct.pack("<II", read_index, sel.shape[0]))
                f.write(sel.astype(np.uint32).tobytes())
    return result


def _score_from_positions(positions: np.ndarray) -> int:
    """mergeAlignmentScore's score recomputation (ReadMapper.hpp:376-382).

    The reference sums (p[i+1]-p[i]-1) over the ascending positions; the
    telescoped closed form n - ((p[-1]-p[0]) - (n-1)) is integer-exact."""
    n = positions.shape[0]
    if n == 0:
        return 1
    return int(2 * n - 1 - (int(positions[-1]) - int(positions[0])))


def _process_chunk(chunk, reads, pair_data, max_chaining_band, used_coverage,
                   accum, mesh=None):
    """Calibrated per-chunk device/host routing: the chain-DP twins are
    bit-identical, so the gate is free to move mid-stage (utils/devwarm)."""
    from ..utils import devwarm
    if not _device_enabled():
        return _process_chunk_impl(False, chunk, reads, pair_data,
                                   max_chaining_band, used_coverage, accum,
                                   mesh)
    n_pairs = sum(pair_data[i][0].shape[0] for i in chunk)
    with devwarm.gate("correction chain DP", n_pairs) as g:
        return _process_chunk_impl(g.device, chunk, reads, pair_data,
                                   max_chaining_band, used_coverage, accum,
                                   mesh)


def _process_chunk_impl(use_device, chunk, reads, pair_data,
                        max_chaining_band, used_coverage, accum, mesh=None):
    # build the pair table over chunk reads
    tbl_pairs = []
    tbl_reads = []
    tbl_pos = []
    tbl_rev = []
    for i in chunk:
        packed, centers, is_rev = pair_data[i]
        tbl_pairs.append(packed)
        tbl_reads.append(np.full(packed.shape[0], i, np.int64))
        tbl_pos.append(centers)
        tbl_rev.append(is_rev)
    if not tbl_pairs:
        return
    tbl_pairs = np.concatenate(tbl_pairs)
    tbl_reads = np.concatenate(tbl_reads)
    tbl_pos = np.concatenate(tbl_pos)
    tbl_rev = np.concatenate(tbl_rev)

    mesh_results = None
    if mesh is not None and mesh.devices.size > 1:
        # sharded join: one negotiated all_to_all exchange for the whole
        # chunk; matches come back as ascending original-table indices,
        # identical to the sorted-table searchsorted expansion below
        from ..parallel.pair_join import pair_join_mesh
        q_parts = []
        q_reads = []
        for read_index, read in enumerate(reads):
            if read.minimizers.shape[0] < MIN_READ_MINIMIZERS:
                continue
            packed = pair_data[read_index][0]
            if packed.shape[0] == 0:
                continue
            q_parts.append(packed)
            q_reads.append(read_index)
        if not q_parts:
            return
        q_cat = np.concatenate(q_parts)
        q_lens = np.fromiter((p.shape[0] for p in q_parts), np.int64,
                             len(q_parts))
        q_offs = np.concatenate([[0], np.cumsum(q_lens)])
        counts_all, matches_all = pair_join_mesh(mesh, tbl_pairs, q_cat)
        moffs = np.concatenate([[0], np.cumsum(counts_all)])
        q_slot = {r: i for i, r in enumerate(q_reads)}
        mesh_results = (q_slot, q_offs, counts_all, matches_all, moffs)
    else:
        order = np.argsort(tbl_pairs, kind="stable")
        tbl_pairs = tbl_pairs[order]
        tbl_reads = tbl_reads[order]
        tbl_pos = tbl_pos[order]
        tbl_rev = tbl_rev[order]

    # query every read against the table (ReadMapper.hpp:632-845)
    for read_index, read in enumerate(reads):
        if read.minimizers.shape[0] < MIN_READ_MINIMIZERS:
            continue
        packed, centers, q_rev = pair_data[read_index]
        if packed.shape[0] == 0:
            continue
        if mesh_results is not None:
            q_slot, q_offs, counts_all, matches_all, moffs = mesh_results
            ri = q_slot[read_index]
            counts = counts_all[q_offs[ri]:q_offs[ri + 1]]
            total = int(counts.sum())
            if total == 0:
                continue
            q_sel = np.repeat(np.arange(packed.shape[0]), counts)
            j = matches_all[moffs[q_offs[ri]]:moffs[q_offs[ri + 1]]]
        else:
            lo = np.searchsorted(tbl_pairs, packed, side="left")
            hi = np.searchsorted(tbl_pairs, packed, side="right")
            counts = hi - lo
            total = int(counts.sum())
            if total == 0:
                continue
            # expand ranges into anchor arrays (gather order: query index
            # asc, table order asc — matches the reference's loops)
            q_sel = np.repeat(np.arange(packed.shape[0]), counts)
            offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
            j = np.repeat(lo - offs, counts) + np.arange(total)
        t_read = tbl_reads[j]
        keep = t_read != read_index
        if not keep.any():
            continue
        q_sel = q_sel[keep]
        t_read = t_read[keep]
        a_ref_pos = tbl_pos[j[keep]]
        a_q_pos = centers[q_sel]
        a_rev = tbl_rev[j[keep]] != q_rev[q_sel]

        # sort by (target read, refPos, queryPos) (ReadMapper.hpp:745-756)
        order2 = np.lexsort((a_q_pos, a_ref_pos, t_read))
        t_read = t_read[order2]
        a_ref_pos = a_ref_pos[order2]
        a_q_pos = a_q_pos[order2]
        a_rev = a_rev[order2]
        q_sel = q_sel[order2]

        starts = np.concatenate(
            [[0], np.flatnonzero(np.diff(t_read)) + 1, [t_read.shape[0]]])

        entries = None
        if not use_device:
            # one native call for all of this read's target groups (the
            # per-pair dispatch was ~30 s of an 86 Mbp ONT run); groups
            # with <3 anchors can't chain and come back as INT32_MIN
            from ..sketch import native_sketch
            from .chainer import CHAIN_MAX_DIST, CHAIN_MAX_GAP, CHAIN_W
            res = native_sketch.chain_mapper_batch(
                a_ref_pos, a_q_pos, a_rev, q_sel, starts.astype(np.int64),
                max_chaining_band, float(CHAIN_W), CHAIN_MAX_DIST,
                CHAIN_MAX_GAP)
            if res is not None:
                g_scores, pos_offsets, positions = res
                entries = [
                    (int(t_read[starts[g]]), int(g_scores[g]),
                     positions[pos_offsets[g]:pos_offsets[g + 1]])
                    for g in np.flatnonzero(
                        g_scores > native_sketch._I32_MIN)]

        if entries is None:
            groups = []
            group_targets = []
            for s, e in zip(starts[:-1], starts[1:]):
                if e - s < 3:  # processAnchors minimum (ReadMapper.hpp:850)
                    continue
                groups.append((a_ref_pos[s:e], a_q_pos[s:e], a_rev[s:e],
                               q_sel[s:e]))
                group_targets.append(int(t_read[s]))
            if use_device and groups:
                chained_all = _chain_groups_device(groups, max_chaining_band)
            else:
                chained_all = [chain_read_pair(*g, max_chaining_band)
                               for g in groups]
            entries = []
            for tgt, chained in zip(group_targets, chained_all):
                if chained is None:
                    continue
                score, positions = chained
                entries.append((tgt, score, positions))

        selected = _select_union(packed.shape[0], entries, used_coverage)
        if not selected:
            continue
        sel_set = set(selected)
        bucket = accum.setdefault(read_index, [])
        for (tgt, score, positions) in entries:
            if tgt in sel_set:
                # copy: native-path positions are views into the group batch
                bucket.append((tgt, np.ascontiguousarray(positions)))
