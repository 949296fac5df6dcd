"""MDBG construction: k-min-mer nodes -> compacted unitig graph (vectorized).

Replaces the reference's BooPHF edge index + sequential walks
(src/graph/CreateMdbg.cpp:1178-3287) with array algorithms:

- adjacency by sort-merge join on raw (k-1)-overlap hashes over 2N oriented
  k-min-mers (successor(x) = all y with seq(x)[1:] == seq(y)[:-1]);
- unitig compaction via chain pointers (outdeg(x)==1 and indeg(next)==1,
  mirroring computeUnitigNode2's single-successor/single-predecessor walk,
  src/graph/CreateMdbg.hpp:2513-2918) resolved by pointer jumping;
- circular unitigs rotated to start at the k-min-mer with smallest normalized
  hash128 and oriented so that k-min-mer is in normalized form
  (src/graph/CreateMdbg.hpp:2733-2795);
- deterministic renaming: normalized unitig sequences sorted by hash128,
  indices 0,2,4,... (computeDeterministicUnitigs, src/graph/CreateMdbg.cpp:1002-1052);
- unitig-level edges: successors(t) = oriented unitigs s with
  first(s)[:-1] == last(t)[1:], excluding the hairpin s == rc(t)
  (getSuccessors_unitig skip rules, src/graph/CreateMdbg.cpp:2453-2520);
  the "predecessors" list of u is successors(rc(u)).

All tables are (rows, k) u32 arrays keyed by 128-bit murmur hashes — the
layout the mesh path shards by hash across devices.
"""

import dataclasses

import numpy as np

from ..count.kminmers import count_unique_rows, normalize_rows, sort_rows_lex
from ..utils.hashing import murmur128_u32rows


def _row_hash_keys(rows: np.ndarray) -> np.ndarray:
    """(N,2) u64 keys = murmur128 of raw rows (not normalized)."""
    h1, h2 = murmur128_u32rows(rows)
    return np.stack([h1, h2], axis=1)


def _join(keys_a: np.ndarray, keys_b: np.ndarray):
    """All pairs (i, j) with keys_a[i] == keys_b[j]. Returns (ai, bj) arrays."""
    if keys_a.shape[0] == 0 or keys_b.shape[0] == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    both = np.concatenate([keys_a, keys_b])
    src = np.concatenate([np.zeros(keys_a.shape[0], np.int8),
                          np.ones(keys_b.shape[0], np.int8)])
    idx = np.concatenate([np.arange(keys_a.shape[0]),
                          np.arange(keys_b.shape[0])])
    order = np.lexsort((src, both[:, 1], both[:, 0]))
    bs, ss, ii = both[order], src[order], idx[order]
    # group boundaries
    new_group = np.empty(bs.shape[0], dtype=bool)
    new_group[0] = True
    np.not_equal(bs[1:], bs[:-1]).any(axis=1, out=new_group[1:])
    group_id = np.cumsum(new_group) - 1
    # per group: cross product of a-indices x b-indices
    out_a, out_b = [], []
    starts = np.flatnonzero(new_group)
    ends = np.append(starts[1:], bs.shape[0])
    counts_a = np.zeros(starts.shape[0], np.int64)
    counts_b = np.zeros(starts.shape[0], np.int64)
    np.add.at(counts_a, group_id[ss == 0], 1)
    np.add.at(counts_b, group_id[ss == 1], 1)
    interesting = np.flatnonzero((counts_a > 0) & (counts_b > 0))
    for g in interesting.tolist():
        seg_idx = ii[starts[g]:ends[g]]
        seg_src = ss[starts[g]:ends[g]]
        a = seg_idx[seg_src == 0]
        b = seg_idx[seg_src == 1]
        aa = np.repeat(a, b.shape[0])
        bb = np.tile(b, a.shape[0])
        out_a.append(aa)
        out_b.append(bb)
    if not out_a:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(out_a), np.concatenate(out_b)


@dataclasses.dataclass
class UnitigGraph:
    """Compacted unitig graph in array form.

    unitig u (0..U-1) has oriented indices 2u (forward) / 2u+1 (reverse) —
    the reference's `unitigIndex` encoding. sequences[u] is the deterministic
    normalized minimizer sequence.
    """
    k: int
    sequences: list                  # U arrays of u32 minimizers
    successors: list                 # 2U lists of oriented indices
    abundances: list | None = None   # U arrays of per-kminmer abundance

    @property
    def n_unitigs(self):
        return len(self.sequences)

    def n_edges(self):
        return sum(len(s) for s in self.successors)


def build_unitig_graph(nodes: np.ndarray, k: int) -> UnitigGraph:
    """nodes: (N, k) u32 normalized unique k-min-mers."""
    nodes = np.ascontiguousarray(nodes, dtype=np.uint32)
    n = nodes.shape[0]
    if n == 0:
        return UnitigGraph(k, [], [])

    # oriented node x in [0, 2n): seq(2i)=nodes[i], seq(2i+1)=reversed
    oriented = np.empty((2 * n, k), np.uint32)
    oriented[0::2] = nodes
    oriented[1::2] = nodes[:, ::-1]

    suffix_keys = _row_hash_keys(oriented[:, 1:])    # seq[1:]
    prefix_keys = _row_hash_keys(oriented[:, :-1])   # seq[:-1]

    src, dst = _join(suffix_keys, prefix_keys)       # edges src -> dst

    outdeg = np.bincount(src, minlength=2 * n)
    indeg = np.bincount(dst, minlength=2 * n)

    # chain pointer: x -> y iff outdeg[x]==1 and indeg[y]==1
    nxt = np.full(2 * n, -1, np.int64)
    single_out = outdeg[src] == 1
    cand = src[single_out]
    cand_dst = dst[single_out]
    ok = indeg[cand_dst] == 1
    nxt[cand[ok]] = cand_dst[ok]
    # mirror symmetry guarantees prv[y]==x iff nxt[x]==y
    prv = np.full(2 * n, -1, np.int64)
    prv[nxt[nxt >= 0]] = np.flatnonzero(nxt >= 0)

    sequences = _extract_unitigs(oriented, nxt, prv, k)
    sequences = _deterministic_order(sequences)
    successors = _unitig_edges(sequences, k)
    return UnitigGraph(k, sequences, successors)


def _extract_unitigs(oriented: np.ndarray, nxt: np.ndarray, prv: np.ndarray,
                     k: int) -> list:
    """Maximal chain paths + cycles -> unitig minimizer sequences (both
    orientations produced, deduplicated by normalized form)."""
    n2 = oriented.shape[0]
    visited = np.zeros(n2, bool)
    sequences = {}

    def add_sequence(seq: np.ndarray):
        norm, _ = normalize_rows(seq[None, :])
        sequences[norm[0].tobytes()] = norm[0]

    # linear paths: start at nodes with no chain-predecessor
    starts = np.flatnonzero(prv < 0)
    for s in starts.tolist():
        path = [s]
        visited[s] = True
        x = s
        while nxt[x] >= 0:
            x = nxt[x]
            if x == s or visited[x] and x != s:
                break  # safety (shouldn't happen for linear)
            path.append(x)
            visited[x] = True
        seq = np.concatenate([oriented[path[0]],
                              oriented[path[1:], -1]]) if len(path) > 1 else oriented[path[0]].copy()
        add_sequence(seq)

    # cycles: remaining unvisited nodes with nxt pointers
    for s in np.flatnonzero(~visited).tolist():
        if visited[s]:
            continue
        cycle = [s]
        visited[s] = True
        x = nxt[s]
        while x != s and x >= 0 and not visited[x]:
            cycle.append(x)
            visited[x] = True
            x = nxt[x]
        if x != s:
            # degenerate (hairpin chain) — treat as linear
            seq = np.concatenate([oriented[cycle[0]], oriented[cycle[1:], -1]]) \
                if len(cycle) > 1 else oriented[cycle[0]].copy()
            add_sequence(seq)
            continue
        add_sequence(_canonical_cycle(oriented, cycle, k))

    return list(sequences.values())


def _canonical_cycle(oriented: np.ndarray, cycle: list, k: int) -> np.ndarray:
    """Rotate/orient a circular unitig per computeUnitigNode2
    (src/graph/CreateMdbg.hpp:2733-2795): anchor at the member k-min-mer with
    the smallest normalized hash128, oriented so the anchor reads in its
    normalized form; spelled as anchor + subsequent last-minimizers."""
    members = oriented[cycle]                      # (C, k) walk orientation
    norm, is_rev = normalize_rows(members)
    h1, h2 = murmur128_u32rows(norm)
    keys = np.stack([h1, h2], axis=1)
    best = np.lexsort((keys[:, 1], keys[:, 0]))[0]
    if is_rev[best]:
        # reverse the cycle: walk the reversed orientation
        members = members[::-1, ::-1]
        # find anchor again (same normalized hash)
        norm2, _ = normalize_rows(members)
        h1b, h2b = murmur128_u32rows(norm2)
        best = int(np.flatnonzero((h1b == keys[best, 0]) & (h2b == keys[best, 1]))[0])
    rolled = np.roll(members, -best, axis=0)
    return np.concatenate([rolled[0], rolled[1:, -1]])


def _deterministic_order(sequences: list) -> list:
    """Sort normalized unitig sequences by hash128 ascending
    (computeDeterministicUnitigs, src/graph/CreateMdbg.cpp:1038-1049)."""
    if not sequences:
        return sequences
    keys = np.array([tuple(murmur128_u32rows(s[None, :])[i][0] for i in (0, 1))
                     for s in sequences], dtype=np.uint64)
    order = np.lexsort((keys[:, 1], keys[:, 0]))
    return [sequences[i] for i in order.tolist()]


def _unitig_edges(sequences: list, k: int) -> list:
    """successors[t] for all 2U oriented unitigs; t=2u forward, 2u+1 reversed.

    Edge t -> s iff last(t)[1:] == first(s)[:-1]; hairpin s == rc(t) excluded
    (the two skip rules in getSuccessors_unitig, CreateMdbg.cpp:2499,2512).
    """
    u = len(sequences)
    successors = [[] for _ in range(2 * u)]
    if u == 0:
        return successors
    firsts = np.empty((2 * u, k), np.uint32)
    lasts = np.empty((2 * u, k), np.uint32)
    for i, seq in enumerate(sequences):
        firsts[2 * i] = seq[:k]
        lasts[2 * i] = seq[-k:]
        rev = seq[::-1]
        firsts[2 * i + 1] = rev[:k]
        lasts[2 * i + 1] = rev[-k:]

    last_sfx = _row_hash_keys(lasts[:, 1:])
    first_pfx = _row_hash_keys(firsts[:, :-1])
    src, dst = _join(last_sfx, first_pfx)
    keep = dst != (src ^ 1)  # exclude t -> rc(t)
    for s, d in zip(src[keep].tolist(), dst[keep].tolist()):
        successors[s].append(d)
    return successors


def compute_unitig_abundances(graph: UnitigGraph, solid_rows: np.ndarray,
                              solid_counts: np.ndarray):
    """Per-kminmer abundance vectors (dumpUnitigAbundances,
    src/graph/CreateMdbg.cpp:3289-3399): solid lookup else 1.

    One batched lookup over every unitig's windows: the per-unitig loop
    re-hashed + re-sorted the whole solid table each call — O(unitigs x
    table), 160 s of a 228 s first pass on a 12 Mb metagenome."""
    from ..count.kminmers import _lookup_rows, batch_extract_kminmers

    rows, _, _, offsets = batch_extract_kminmers(graph.sequences, graph.k)
    vals, _ = _lookup_rows(rows, solid_rows,
                           solid_counts.astype(np.uint32), 1)
    vals = vals.astype(np.uint32)
    abundances = [vals[offsets[i]:offsets[i + 1]]
                  for i in range(len(graph.sequences))]
    graph.abundances = abundances
    return abundances
