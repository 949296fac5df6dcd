"""Device kernels at production shapes vs their host twins, on a CUDA GPU.

Every comparison is bitwise. No device path has a matrix product, so TF32
never arises: the sketch and row-counting kernels are integer-only, and
the chain DP adds f32 scores in the same order as its host twins and
breaks `argmax` ties the same way (kernels/chain_jax.py).

Each test records, under the `kernel` user property, the compiled
program's `memory_analysis()`, the first call's wall (compile included)
and the device and host seconds per item. `chip_smoke.py` prints them.
Run on a GPU host with:
    METAMDBG_TPU_TESTS_ON_DEVICE=1 JAX_PLATFORMS=cuda pytest -m gpu
"""

import re
import time

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

_MEM_FIELDS = ("argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "generated_code_size_in_bytes")


def _memory(compiled) -> dict:
    m = compiled.memory_analysis()
    return {f: int(getattr(m, f)) for f in _MEM_FIELDS}


def _timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def _report(record_property, name, items, compiled, first_s, device_s,
            host_s, **extra):
    record_property("kernel", {
        "kernel": name, "items": int(items), "memory": _memory(compiled),
        "first_call_s": first_s, "device_s_per_item": device_s / items,
        "host_s_per_item": host_s / items, **extra})


# -- sketch: one (TILE_ROWS, TILE_LEN) tile shape, ~8 Mbp of 10 kb reads ----

def test_sketch_tile_matches_host(gpu, record_property):
    from metamdbg_tpu.kernels import sketch as dsketch
    from metamdbg_tpu.sketch import batch, read_selection

    l, density = 15, 0.005
    rng = np.random.default_rng(11)
    codes, bads = [], []
    total = 0
    while total < batch.TILE_ROWS * batch.TILE_LEN:
        n = max(500, int(rng.normal(10_000, 10_000 / 6)))
        c = rng.integers(0, 4, n).astype(np.uint8)
        bad = rng.random(n) < 1e-4
        codes.append(c)
        bads.append(bad)
        total += n

    sk = batch.BatchSketcher(l, density)
    _, first_s = _timed(sk.sketch_many, codes, bads)
    dev, device_s = _timed(sk.sketch_many, codes, bads)
    host, host_s = _timed(read_selection._sketch_chunk_host,
                          list(zip(codes, bads)), l, density, None)
    for i, ((dv, dp, dd), (hv, hp, hd)) in enumerate(zip(dev, host)):
        assert np.array_equal(dv, hv), i
        assert np.array_equal(dp, hp), i
        assert np.array_equal(dd, hd), i

    nk = batch.TILE_LEN - l + 1
    cap = dsketch.compact_cap(nk, density)
    tile = np.zeros((batch.TILE_ROWS, batch.TILE_LEN), np.uint8)
    packed, bad_packed = dsketch.pack_codes(tile)
    compiled = dsketch.sketch_batch_compact_packed.lower(
        packed, bad_packed, np.full(batch.TILE_ROWS, batch.TILE_LEN,
                                    np.int32),
        l=l, density=density, cap=cap).compile()
    _report(record_property, "sketch_batch_compact_packed", total, compiled,
            first_s, device_s, host_s,
            shape=[batch.TILE_ROWS, batch.TILE_LEN],
            device_gbases_per_s=total / device_s / 1e9,
            entry_ops=_entry_ops(compiled))


def _entry_ops(compiled) -> dict:
    """Launch-level ops of the optimized program: how many fusions, sorts
    and custom calls its ENTRY computation runs."""
    entry = compiled.as_text().split("\nENTRY ", 1)[1].split("\n}", 1)[0]
    ops = re.findall(r"\s(fusion|sort|custom-call)\(", entry)
    return {op: ops.count(op) for op in sorted(set(ops))}


# -- row counting: the _DEVICE_COUNT_MIN_ROWS gate up to a first-pass table -

@pytest.mark.parametrize("k,n_rows", [(4, 1 << 16), (4, 5_000_000),
                                      (5, 5_000_000), (100, 1 << 16)])
def test_count_rows_matches_host(gpu, record_property, k, n_rows):
    from metamdbg_tpu.count import kminmers
    from metamdbg_tpu.kernels import count_jax

    rng = np.random.default_rng(k * 7 + n_rows)
    # ~3 occurrences per distinct row, like a first pass at ~25x coverage
    vocab = rng.integers(0, 1 << 30, size=(max(n_rows // 3, 1), k),
                         dtype=np.uint32)
    rows = vocab[rng.integers(0, vocab.shape[0], n_rows)]

    _, first_s = _timed(count_jax.count_unique_rows_device, rows)
    (du, dc), device_s = _timed(count_jax.count_unique_rows_device, rows)
    (hu, hc), host_s = _timed(kminmers._count_unique_rows_host, rows)
    assert np.array_equal(du, hu)
    assert np.array_equal(dc, hc)

    p = count_jax._pad_size(n_rows)
    cols = tuple(np.zeros(p, np.uint32) for _ in range(k))
    compiled = count_jax._sort_rows.lower(cols, k=k).compile()
    _report(record_property, f"count_unique_rows_device[k={k}]", n_rows,
            compiled, first_s, device_s, host_s, padded_rows=p)


# -- chain DP: each anchor-count bucket of both mappers -------------------

def _anchor_groups(rng, n_groups, bucket, span):
    """(P, bucket) padded collinear anchor groups sorted by (ref, query),
    each with more anchors than the next smaller bucket holds."""
    lo = bucket // 4 + 1
    ref_pos = np.zeros((n_groups, bucket), np.int64)
    q_pos = np.zeros((n_groups, bucket), np.int64)
    is_rev = np.zeros((n_groups, bucket), bool)
    n_anchors = rng.integers(lo, bucket + 1, n_groups)
    for p in range(n_groups):
        n = int(n_anchors[p])
        ref = np.sort(rng.integers(0, span, n))
        q = np.clip(ref + rng.integers(-3, 4, n), 0, span - 1)
        noisy = rng.random(n) < 0.1
        q[noisy] = rng.integers(0, span, int(noisy.sum()))
        rev = rng.random() < 0.5
        if rev:
            q = span - 1 - q
        order = np.lexsort((q, ref))
        ref_pos[p, :n] = ref[order]
        q_pos[p, :n] = q[order]
        is_rev[p, :n] = rev
    return ref_pos, q_pos, is_rev, n_anchors


@pytest.mark.parametrize("bucket", [64, 256, 1024, 4096])
def test_correction_chain_matches_host(gpu, record_property, bucket):
    from metamdbg_tpu.correction.chainer import chain_dp
    from metamdbg_tpu.correction.mapper import _CHAIN_BUCKETS
    from metamdbg_tpu.kernels import chain_jax

    assert bucket in _CHAIN_BUCKETS
    band = int(np.float32(2500) * np.float32(0.025))  # correction density
    rng = np.random.default_rng(bucket)
    # one read against its candidate targets: the mapper calls the kernel
    # once per read per bucket
    groups = _anchor_groups(rng, 64, bucket, 3 * bucket)
    n_anchors = groups[3]

    _, first_s = _timed(chain_jax.chain_dp_device, *groups, band)
    (scores, parents, best), device_s = _timed(chain_jax.chain_dp_device,
                                               *groups, band)
    t0 = time.perf_counter()
    for p in range(n_anchors.shape[0]):
        n = int(n_anchors[p])
        hs, hp, hb = chain_dp(groups[0][p, :n], groups[1][p, :n],
                              groups[2][p, :n], band)
        assert np.array_equal(hs, scores[p, :n]), p
        assert np.array_equal(hp, parents[p, :n].astype(np.int64)), p
        assert int(hb) == int(best[p]), p
    host_s = time.perf_counter() - t0

    compiled = chain_jax._chainer(bucket, band).lower(*groups).compile()
    _report(record_property, f"chain_dp_device[{bucket}]",
            int(n_anchors.shape[0]), compiled, first_s, device_s, host_s,
            rows=int(n_anchors.shape[0]), anchors=int(n_anchors.sum()))


@pytest.mark.parametrize("bucket", [64, 256, 1024, 4096])
def test_contig_chain_matches_host(gpu, record_property, bucket):
    from metamdbg_tpu.basespace import contig_mapper as cm
    from metamdbg_tpu.kernels import chain_jax
    from metamdbg_tpu.sketch import native_sketch

    assert bucket in cm._CHAIN_BUCKETS
    avg_dist = 200.0
    drm = cm._d_r_max(avg_dist)
    rng = np.random.default_rng(bucket + 1)
    # a 65536-read chunk's groups of this bucket: ~256k anchors
    n_groups = (1 << 18) // bucket
    ref_pos, q_pos, is_rev, n_anchors = _anchor_groups(rng, n_groups, bucket,
                                                       3 * bucket)
    read_bp = np.cumsum(rng.integers(100, 300, 3 * bucket)).astype(np.int64)
    q_bp = read_bp[q_pos]
    args = (ref_pos, q_pos, q_bp, is_rev, n_anchors, cm.CHAIN_BAND, drm,
            float(cm.CHAIN_W), 100, 5000)

    _, first_s = _timed(chain_jax.chain_contig_device, *args)
    (_, parents, best), device_s = _timed(chain_jax.chain_contig_device,
                                          *args)
    garrs = [(ref_pos[p, :n], q_pos[p, :n], q_bp[p, :n], is_rev[p, :n])
             for p, n in enumerate(n_anchors.tolist())]
    (h_best, h_parents), host_s = _timed(
        native_sketch.chain_batch_native, garrs, avg_dist, cm.CHAIN_BAND,
        float(cm.CHAIN_W), 100, 5000)
    assert np.array_equal(best, np.asarray(h_best, np.int32))
    for p, n in enumerate(n_anchors.tolist()):
        assert np.array_equal(parents[p, :n], np.asarray(h_parents[p])), p

    compiled = chain_jax._chainer_contig(
        bucket, cm.CHAIN_BAND, drm, float(cm.CHAIN_W), 100, 5000).lower(
            ref_pos, q_pos, q_bp, is_rev, n_anchors).compile()
    _report(record_property, f"chain_contig_device[{bucket}]", n_groups,
            compiled, first_s, device_s, host_s, rows=n_groups,
            anchors=int(n_anchors.sum()))
