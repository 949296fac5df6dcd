"""metamdbg_tpu — a minimizer-space de Bruijn graph (MDBG) assembler in JAX.

A from-scratch re-design of the metaMDBG method (minimizer-space assembly of
accurate long reads, optimized for metagenomes) for an accelerator:

- sketching, k-min-mer counting and anchor chaining are expressed as batched
  array programs (JAX/XLA), each with a bit-identical host twin,
- multi-chip scale-out uses `jax.sharding` meshes with XLA collectives
  (all_to_all routing of hash-sharded count tables),
- the host runtime (fastq IO, record files, orchestration) is Python + C++.

Layout:
    utils/      bit-exact hashing, u64-as-u32-pair device math, stats
    io/         on-disk record formats (read_data, kminmerData, unitigGraph...)
    sketch/     read selection: RLE, rolling canonical k-mers, minimizers
    kernels/    device kernels (XLA): sketch, row counting, chain DP
    count/      sharded k-min-mer counting, rescue, refined abundances
    graph/      MDBG edges, unitig compaction, simplification, contigs
    correction/ ONT read correction (minimizer-space mapping + POA)
    basespace/  contig reconstruction + polishing
    parallel/   device mesh utilities, sharded tables
    pipeline/   `asm` / `gfa` orchestrator and CLI
"""

__version__ = "0.1.0"
