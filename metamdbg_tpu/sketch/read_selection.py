"""Stage 1 — read selection: reads -> minimizer space.

Re-implements the `readSelection` subcommand
(src/readSelection/ReadSelection.hpp:92-303) as a host-driven batch pipeline:
for each read, homopolymer-compress (HiFi), select minimizers by universe
hash, apply complexity/quality filters, and write `read_data_init.txt`,
`read_stats.txt` and `repetitiveMinimizers.bin`; for HiFi / skip-correction
runs, palindrome-purge into `read_data_corrected.txt`
(ReadSelection.hpp:300-302,1374-1431).

The per-read math lives in sketch/{rle,kmers,minimizers,filters,palindrome}.
The production path batches reads through the device sketch kernel
(kernels/sketch.py via sketch/batch.py) — bit-identical to the host path
(tests/test_sketch.py, tests/test_parity_readselection.py); the per-read
host path remains as the parity oracle.
"""

import os

import numpy as np

from ..constants import (
    COMPLEXITY_MAX_SCORE,
    COMPLEXITY_STEP,
    COMPLEXITY_WINDOW,
    K_FIRST,
    REPETITIVE_MINIMIZER_FRACTION,
    REPETITIVE_MINIMIZER_MAX_READS,
    compute_last_k,
)
from ..io import fastq, records
from ..utils.stats import compute_mean_length, compute_n50
from . import filters, kmers, minimizers, palindrome, rle


_CHUNK_READS = 4096


def _chunked(iterable, n: int):
    chunk = []
    for x in iterable:
        chunk.append(x)
        if len(chunk) == n:
            yield chunk
            chunk = []
    if chunk:
        yield chunk


def _make_sketcher(l: int, density: float, repetitive):
    """Device batch sketcher, or None to always use the host path. Each
    chunk is routed by the calibrated gate (utils/devwarm.py)."""
    if os.environ.get("METAMDBG_TPU_HOST_SKETCH") \
            or os.environ.get("METAMDBG_TPU_HOST_ONLY"):
        return None
    from . import batch
    return batch.BatchSketcher(l, density, repetitive)


def _sketch_chunk(sketcher, chunk, l, density, use_hpc, repetitive):
    """Sketch a chunk of reads. Returns [(mins, pos, dirs, rle_pos)] in
    chunk order. `pos` are k-mer indices in the RLE'd read."""
    from ..utils import devwarm
    rles = [rle.rle_encode(read.seq, use_hpc) for read in chunk]
    coded = [kmers.base_codes(seq_rle) for seq_rle, _ in rles]
    total_bases = sum(c.shape[0] for c, _ in coded)
    if sketcher is not None:
        # calibrated routing: the host twin is bit-identical, so the gate
        # picks whichever side is measured faster on this machine
        with devwarm.gate("batch sketching", total_bases) as g:
            if g.device:
                res = sketcher.sketch_many([c for c, _ in coded],
                                           [b for _, b in coded])
            else:
                res = _sketch_chunk_host(coded, l, density, repetitive)
    else:
        res = _sketch_chunk_host(coded, l, density, repetitive)
    return [(vals, pos, dirs, rles[i][1])
            for i, (vals, pos, dirs) in enumerate(res)]


def _sketch_chunk_host(coded, l, density, repetitive):
    """Host twin of the device batch sketcher: native engine when built,
    numpy otherwise. Returns [(mins, pos, dirs)] in chunk order."""
    from . import native_sketch
    if native_sketch.available():
        res = native_sketch.sketch_batch_native(
            [c for c, _ in coded], [b for _, b in coded], l, density,
            repetitive)
        if res is not None:
            return res
    return [minimizers.select_minimizers_numpy(codes, bad, l, density,
                                               repetitive)
            for codes, bad in coded]


def determine_repetitive_minimizers(input_paths, out_path: str, l: int,
                                    density_correction: float,
                                    use_hpc: bool) -> np.ndarray:
    """ONT-only blacklist of hyper-abundant minimizers (ReadSelection.hpp:497-561).

    Counts minimizers at correction density over the first 1M reads and bans
    the top 1e-5 fraction (>= 1). Skipped (empty file) when HPC is on (HiFi).

    Determinism note: the reference sorts ties in abundance in unordered_map
    iteration order; we tie-break by minimizer value descending, which is
    deterministic and keeps the same abundance threshold.
    """
    if use_hpc:
        open(out_path, "wb").close()
        return np.zeros(0, dtype=np.uint32)

    counts: dict[int, int] = {}
    sketcher = _make_sketcher(l, density_correction, None)
    reads = fastq.iter_reads(input_paths,
                             max_reads=REPETITIVE_MINIMIZER_MAX_READS,
                             need_headers=False)
    for chunk in _chunked(reads, _CHUNK_READS):
        for mins, _, _, _ in _sketch_chunk(sketcher, chunk, l,
                                           density_correction, use_hpc, None):
            vals, cnt = np.unique(mins, return_counts=True)
            for v, c in zip(vals.tolist(), cnt.tolist()):
                counts[v] = counts.get(v, 0) + c

    if not counts:
        open(out_path, "wb").close()
        return np.zeros(0, dtype=np.uint32)

    items = np.array(sorted(counts.items(), key=lambda kv: (-kv[1], -kv[0])),
                     dtype=np.int64)
    nb = max(int(REPETITIVE_MINIMIZER_FRACTION * len(items)), 1)
    banned = items[:nb, 0].astype(np.uint32)
    records.save_repetitive_minimizers(out_path, banned)
    return np.sort(banned)


def run_read_selection(input_paths, out_dir: str, params: records.Parameters,
                       min_read_quality: float = 0.0,
                       skip_correction: bool = False) -> records.ReadStats:
    """Full stage; returns the computed ReadStats."""
    l = params.minimizer_size
    density = params.density_assembly
    use_hpc = params.use_homopolymer_compression

    repetitive = determine_repetitive_minimizers(
        input_paths, os.path.join(out_dir, "repetitiveMinimizers.bin"),
        l, params.density_correction, use_hpc)
    repetitive = np.sort(repetitive)

    out_path = os.path.join(out_dir, "read_data_init.txt")
    all_read_sizes = []
    nb_kmers = 0
    nb_bases = 0
    nb_minimizers = 0
    quality_sum = np.longdouble(0.0)
    quality_n = 0
    nb_low_quality = 0
    nb_low_complexity = 0

    sketcher = _make_sketcher(l, density, repetitive if repetitive.size
                              else None)
    with records.ReadDataWriter(out_path, with_quality=True) as writer:
        for chunk in _chunked(fastq.iter_reads(input_paths,
                                                need_headers=False),
                              _CHUNK_READS):
            sketched = _sketch_chunk(sketcher, chunk, l, density, use_hpc,
                                     repetitive)
            # batched complexity + mean-quality filters (native; the
            # per-read numpy versions remain the oracle and fallback)
            from . import native_sketch
            batch_filters = native_sketch.read_filters_batch(
                [r.seq for r in chunk], [r.qual for r in chunk],
                COMPLEXITY_WINDOW, COMPLEXITY_STEP, filters._QUAL_TABLE) \
                if native_sketch.available() else None
            for ri, (read, (mins, pos, dirs, rle_pos)) in enumerate(
                    zip(chunk, sketched)):
                if batch_filters is not None:
                    complexity = float(batch_filters[0][ri])
                    mean_q = float(batch_filters[1][ri])
                else:
                    mean_q = filters.mean_read_quality(read.qual)
                    complexity = filters.sequence_complexity(read.seq)

                if complexity > COMPLEXITY_MAX_SCORE:  # NaN -> False (keep)
                    nb_low_complexity += 1
                    mins = np.zeros(0, np.uint32)
                    pos = np.zeros(0, np.uint32)
                    dirs = np.zeros(0, np.uint8)

                if mean_q < min_read_quality:  # NaN compares False (keep)
                    nb_low_quality += 1
                    mins = np.zeros(0, np.uint32)
                    pos = np.zeros(0, np.uint32)
                    dirs = np.zeros(0, np.uint8)
                else:
                    quality_sum += np.longdouble(mean_q)
                    quality_n += 1

                quals = filters.minimizer_min_qualities(read.qual, rle_pos,
                                                        pos, l)

                writer.write(records.MinimizerRead(
                    read.index, mins, pos, dirs, quals, mean_q,
                    read.seq.shape[0]))

                all_read_sizes.append(read.seq.shape[0])
                nb_minimizers += mins.shape[0]
                nb_kmers += read.seq.shape[0] - l + 1
                nb_bases += read.seq.shape[0]

    sizes = np.asarray(all_read_sizes, dtype=np.uint32)
    stats = records.ReadStats(
        nb_reads=len(all_read_sizes),
        n50=compute_n50(sizes),
        density=float(np.float32(np.longdouble(nb_minimizers) / np.longdouble(nb_kmers)))
        if nb_kmers else 0.0,
        nb_bases=nb_bases,
        avg_quality=float(np.float32(quality_sum / quality_n)) if quality_n else 0.0,
        mean_length=compute_mean_length(sizes),
        nb_minimizers=nb_minimizers,
    )
    stats.save(os.path.join(out_dir, "read_stats.txt"))

    if use_hpc or skip_correction:
        purge_palindromes(out_path,
                          os.path.join(out_dir, "read_data_corrected.txt"),
                          params, stats.n50)
    return stats


def purge_palindromes(in_path: str, out_path: str, params: records.Parameters,
                      n50_read_length: int):
    """HiFi path: rewrite reads with palindromic windows removed
    (ReadSelection.hpp:1374-1431)."""
    last_k = compute_last_k(params.density_assembly, n50_read_length,
                            params.kminmer_size_first, 0)
    with records.ReadDataWriter(out_path, with_quality=False) as writer:
        for read in records.read_read_data(in_path, with_quality=True):
            purged = palindrome.purge_palindrome(
                read.minimizers, params.kminmer_size_first, last_k)
            writer.write(records.MinimizerRead(
                read.index, purged, None, None, None))
