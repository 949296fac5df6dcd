"""Device sketch path must agree bit-exactly with the host golden path."""

import numpy as np

from metamdbg_tpu.kernels import sketch as dsketch
from metamdbg_tpu.sketch import kmers, minimizers


def test_device_sketch_matches_host():
    rng = np.random.default_rng(3)
    seqs = [bytes(rng.choice(list(b"ACGT"), size=int(n)).tolist())
            for n in rng.integers(200, 2000, size=16)]
    seqs[3] = seqs[3][:100] + b"N" + seqs[3][101:]  # bad char case

    codes, lengths = dsketch.encode_reads(seqs)
    out = dsketch.sketch_batch(codes, lengths, l=15, density=0.02)
    dev = dsketch.extract_minimizers(out, lengths)

    for i, s in enumerate(seqs):
        b = np.frombuffer(s, np.uint8)
        c, bad = kmers.base_codes(b)
        mins, pos, dirs = minimizers.select_minimizers(c, bad, 15, 0.02)
        dv, dp, dd = dev[i]
        np.testing.assert_array_equal(dv, mins, err_msg=f"read {i} values")
        np.testing.assert_array_equal(dp, pos, err_msg=f"read {i} positions")
        np.testing.assert_array_equal(dd, dirs, err_msg=f"read {i} dirs")


def test_sharded_count_table_matches_host():
    """The mesh count table returns the FULL (hash128, count) table and is
    byte-equivalent to host counting on data with duplicates."""
    import jax
    from jax.sharding import Mesh

    from metamdbg_tpu.count.kminmers import (batch_extract_kminmers,
                                             count_unique_rows)
    from metamdbg_tpu.parallel.count_table import count_stats, count_table
    from metamdbg_tpu.utils.hashing import kminmer_hash128

    rng = np.random.default_rng(4)
    reads = [rng.integers(0, 1 << 30, size=int(n), dtype=np.uint32)
             for n in rng.integers(6, 40, size=16)]
    # duplicate some reads to create abundance > 1
    reads = reads + [reads[0].copy(), reads[1].copy()]
    n = len(reads)
    max_m = max(r.shape[0] for r in reads)
    mins = np.zeros((n, max_m), np.uint32)
    lens = np.zeros(n, np.int32)
    for i, r in enumerate(reads):
        mins[i, :r.shape[0]] = r
        lens[i] = r.shape[0]

    k = 4
    rows, _, _, _ = batch_extract_kminmers(reads, k)
    uniq, counts = count_unique_rows(rows)
    host_keys = kminmer_hash128(uniq)
    order = np.lexsort((host_keys[:, 1], host_keys[:, 0]))
    host_keys = host_keys[order]
    host_counts = counts[order]

    devices = np.array(jax.devices()[:8])
    mesh = Mesh(devices, ("data",))
    pad = (-n) % 8
    if pad:
        mins = np.vstack([mins, np.zeros((pad, max_m), np.uint32)])
        lens = np.concatenate([lens, np.zeros(pad, np.int32)])

    keys, cnt = count_table(mesh, mins, lens, k)
    np.testing.assert_array_equal(keys, host_keys)
    np.testing.assert_array_equal(cnt, host_counts.astype(np.uint32))

    distinct, solid, overflow = count_stats(mesh, mins, lens, k)
    assert overflow == 0
    assert distinct == uniq.shape[0]
    assert solid == int((counts > 1).sum()) and solid > 0

