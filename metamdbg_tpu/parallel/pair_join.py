"""Sharded minimizer-pair table join over a device mesh.

The device-mesh twin of ReadMapper's chunked pair-table join
(src/readSelection/ReadMapper.hpp:632-845, re-expressed in
correction/mapper._process_chunk): the all-vs-all mapper builds a sorted
u64 pair table and looks every read's pairs up in it. Here both sides are
data-parallel over the mesh; pairs are routed to their owning shard with
`all_to_all` (hash of the pair mod #shards, capacity NEGOTIATED like
parallel/count_table.py so nothing is dropped), each shard sorts its
table slice and merge-counts the query pairs against it, and the host
reassembles exact match lists.

On a pod this shards the pair table across device memory — the reference
bounds the same table with disk chunks (ReadMapper.hpp:191-193); the
chunked host path remains for single-device runs. Outputs are identical
to the host searchsorted join (tests/test_pair_join.py, and the byte
parity of readAlignmentsLowDensity.bin through run_read_mapper).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _owner(hi, lo, ndev):
    return ((hi ^ lo) % jnp.uint32(ndev)).astype(jnp.int32)


def _round_capacity(n: int) -> int:
    cap = 128
    while cap < n:
        cap *= 2
    return cap


@functools.partial(jax.jit, static_argnames=("ndev", "axis", "mesh"))
def _traffic(hi, lo, valid, ndev, axis, mesh):
    def f(h, l, v):
        shard = _owner(h, l, ndev)
        shard = jnp.where(v, shard, jnp.int32(ndev))
        per = jnp.zeros(ndev + 1, jnp.int32).at[shard.reshape(-1)].add(1)
        return jax.lax.pmax(per[:ndev], axis)
    return jax.shard_map(f, mesh=mesh, in_specs=(P(axis, None),) * 3,
                         out_specs=P())(hi, lo, valid)


def _route(arrs, shard, ndev, cap):
    """Scatter rows into (ndev, cap) buckets by dest shard; returns routed
    arrays + validity. Rows with shard == ndev (invalid) are dropped."""
    n = shard.shape[0]
    order = jnp.argsort(shard, stable=True)
    shard_s = shard[order]
    pos = jnp.arange(n) - jnp.searchsorted(shard_s, shard_s, side="left")
    keep = (shard_s < ndev) & (pos < cap)
    dst = jnp.where(keep, shard_s * cap + jnp.minimum(pos, cap - 1),
                    ndev * cap)
    overflow = ((pos >= cap) & (shard_s < ndev)).sum()
    out = []
    for x in arrs:
        b = jnp.zeros((ndev * cap,), x.dtype).at[dst].set(
            x[order], mode="drop").reshape(ndev, cap)
        out.append(b)
    bv = jnp.zeros((ndev * cap,), bool).at[dst].set(
        True, mode="drop").reshape(ndev, cap)
    return out, bv, overflow


@functools.partial(jax.jit, static_argnames=("ndev", "tcap", "qcap", "axis",
                                             "mesh"))
def _join_step(thi, tlo, tgid, tvalid, qhi, qlo, qgid, qvalid, ndev,
               tcap, qcap, axis, mesh):
    """Route table + query pairs to owner shards; per shard: sort the table
    slice by (pair, gid) and merge-count the queries. Returns per-shard
    sorted table gids and per-query (gid, first, count) plus overflow."""
    def f(th, tl, tg, tv, qh, ql, qg, qv):
        th, tl, tg, tv = [x.reshape(-1) for x in (th, tl, tg, tv)]
        qh, ql, qg, qv = [x.reshape(-1) for x in (qh, ql, qg, qv)]
        tshard = jnp.where(tv, _owner(th, tl, ndev), jnp.int32(ndev))
        qshard = jnp.where(qv, _owner(qh, ql, ndev), jnp.int32(ndev))

        (tb, tbv, tof) = _route([th, tl, tg], tshard, ndev, tcap)
        (qb, qbv, qof) = _route([qh, ql, qg], qshard, ndev, qcap)

        rth, rtl, rtg = [jax.lax.all_to_all(b, axis, 0, 0).reshape(-1)
                         for b in tb]
        rtv = jax.lax.all_to_all(tbv, axis, 0, 0).reshape(-1)
        rqh, rql, rqg = [jax.lax.all_to_all(b, axis, 0, 0).reshape(-1)
                         for b in qb]
        rqv = jax.lax.all_to_all(qbv, axis, 0, 0).reshape(-1)

        big = jnp.uint32(0xFFFFFFFF)
        # merged sort of table + query keys; queries sort after table
        # entries of the same key (tag 1), invalid last
        mh = jnp.concatenate([jnp.where(rtv, rth, big),
                              jnp.where(rqv, rqh, big)])
        ml = jnp.concatenate([jnp.where(rtv, rtl, big),
                              jnp.where(rqv, rql, big)])
        tag = jnp.concatenate([jnp.zeros_like(rth, dtype=jnp.int32),
                               jnp.ones_like(rqh, dtype=jnp.int32)])
        gid = jnp.concatenate([rtg, rqg])
        valid = jnp.concatenate([rtv, rqv])
        order = jnp.lexsort((gid, tag, ml, mh))
        sh, sl = mh[order], ml[order]
        stag, sgid, sv = tag[order], gid[order], valid[order]

        # table-only positions (the shard's sorted table order)
        is_tbl = (stag == 0) & sv
        tpos = jnp.cumsum(is_tbl.astype(jnp.int32)) - 1
        # key groups over the merged order
        head = jnp.ones(sh.shape[0], bool)
        head = head.at[1:].set((sh[1:] != sh[:-1]) | (sl[1:] != sl[:-1]))
        group = jnp.cumsum(head.astype(jnp.int32)) - 1
        nseg = sh.shape[0]
        tbl_count = jax.ops.segment_sum(is_tbl.astype(jnp.int32), group,
                                        num_segments=nseg)
        first_tpos = jax.ops.segment_min(
            jnp.where(is_tbl, tpos, jnp.int32(2**30)), group,
            num_segments=nseg)

        # per query (in routed order): gid, first, count
        is_q = (stag == 1) & sv
        qcount = jnp.where(is_q, tbl_count[group], 0)
        qfirst = jnp.where(is_q, first_tpos[group], 0)

        # compact the shard's sorted table gids into the first T slots
        t_sorted_gid = jnp.zeros(rth.shape[0], jnp.int32)
        t_sorted_gid = t_sorted_gid.at[jnp.where(is_tbl, tpos, rth.shape[0])
                                       ].set(sgid, mode="drop")
        # compact query results into the first Q slots (routed order)
        qpos = jnp.cumsum(is_q.astype(jnp.int32)) - 1
        nq = rqh.shape[0]
        q_gid = jnp.zeros(nq, jnp.int32)
        q_first = jnp.zeros(nq, jnp.int32)
        q_count = jnp.zeros(nq, jnp.int32)
        q_val = jnp.zeros(nq, bool)
        tgt = jnp.where(is_q, qpos, nq)
        q_gid = q_gid.at[tgt].set(sgid, mode="drop")
        q_first = q_first.at[tgt].set(qfirst, mode="drop")
        q_count = q_count.at[tgt].set(qcount, mode="drop")
        q_val = q_val.at[tgt].set(is_q, mode="drop")

        overflow = jax.lax.psum(tof + qof, axis)
        return (t_sorted_gid[None], q_gid[None], q_first[None],
                q_count[None], q_val[None], overflow)

    return jax.shard_map(
        f, mesh=mesh, in_specs=(P(axis, None),) * 8,
        out_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P()))(
        thi, tlo, tgid, tvalid, qhi, qlo, qgid, qvalid)


def pair_join_mesh(mesh: Mesh, tbl_pairs: np.ndarray, query_pairs: np.ndarray,
                   axis: str = "data"):
    """For each query pair: the ascending original-table indices of all
    table entries with the same u64 pair value — identical to
    np.searchsorted on the stably-sorted table. Returns (counts i64[nq],
    matches i64[total] concatenated in query order)."""
    ndev = mesh.shape[axis]
    nt, nq = tbl_pairs.shape[0], query_pairs.shape[0]
    if nt == 0 or nq == 0:
        return np.zeros(nq, np.int64), np.zeros(0, np.int64)

    def pad_rows(x, fill):
        rows = ((x.shape[0] + ndev - 1) // ndev)
        out = np.full(rows * ndev, fill, x.dtype)
        out[:x.shape[0]] = x
        return out.reshape(ndev, rows)

    thi = pad_rows((tbl_pairs >> np.uint64(32)).astype(np.uint32), 0)
    tlo = pad_rows(tbl_pairs.astype(np.uint32), 0)
    tgid = pad_rows(np.arange(nt, dtype=np.int32), 0)
    tvalid = pad_rows(np.ones(nt, bool), False)
    qhi = pad_rows((query_pairs >> np.uint64(32)).astype(np.uint32), 0)
    qlo = pad_rows(query_pairs.astype(np.uint32), 0)
    qgid = pad_rows(np.arange(nq, dtype=np.int32), 0)
    qvalid = pad_rows(np.ones(nq, bool), False)

    sharding = NamedSharding(mesh, P(axis, None))
    dev = lambda x: jax.device_put(jnp.asarray(x), sharding)  # noqa: E731

    t_traffic = np.asarray(_traffic(dev(thi), dev(tlo), dev(tvalid), ndev,
                                    axis, mesh))
    q_traffic = np.asarray(_traffic(dev(qhi), dev(qlo), dev(qvalid), ndev,
                                    axis, mesh))
    tcap = _round_capacity(int(t_traffic.max()) if t_traffic.size else 1)
    qcap = _round_capacity(int(q_traffic.max()) if q_traffic.size else 1)

    (t_sorted_gid, q_gid, q_first, q_count, q_val, overflow) = _join_step(
        dev(thi), dev(tlo), dev(tgid), dev(tvalid), dev(qhi), dev(qlo),
        dev(qgid), dev(qvalid), ndev, tcap, qcap, axis, mesh)
    if int(overflow) != 0:  # not an assert: stripped under python -O, and
        # silent overflow would drop matches and corrupt correction
        raise RuntimeError(
            "pair_join capacity negotiation overflowed: the _traffic/_route "
            "symmetry invariant is broken")

    from .multihost import gather_to_hosts
    t_sorted_gid = gather_to_hosts(t_sorted_gid).reshape(ndev, -1)
    q_gid = gather_to_hosts(q_gid).reshape(ndev, -1)
    q_first = gather_to_hosts(q_first).reshape(ndev, -1)
    q_count = gather_to_hosts(q_count).reshape(ndev, -1)
    q_val = gather_to_hosts(q_val).reshape(ndev, -1)

    counts = np.zeros(nq, np.int64)
    firsts = np.zeros(nq, np.int64)
    shard_of = np.zeros(nq, np.int64)
    for d in range(ndev):
        v = q_val[d]
        counts[q_gid[d][v]] = q_count[d][v]
        firsts[q_gid[d][v]] = q_first[d][v]
        shard_of[q_gid[d][v]] = d

    total = int(counts.sum())
    matches = np.empty(total, np.int64)
    offs = np.concatenate([[0], np.cumsum(counts)])
    for d in range(ndev):
        sel = np.flatnonzero((shard_of == d) & (counts > 0))
        if not sel.size:
            continue
        c = counts[sel]
        intra = np.arange(int(c.sum())) - np.repeat(np.cumsum(c) - c, c)
        src = np.repeat(firsts[sel], c) + intra
        dst = np.repeat(offs[sel], c) + intra
        matches[dst] = t_sorted_gid[d][src]
    return counts, matches
