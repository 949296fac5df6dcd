"""Batched (device) minimizer sketching for the production pipeline.

This drives kernels/sketch.py (the device twin of sketch/minimizers.py)
over fixed-shape tiles of concatenated reads, so the `asm` pipeline's
hottest scan (per-base canonical k-mer + MurmurHash3 threshold selection,
src/readSelection/ReadSelection.hpp:637-1372) runs on device instead of one
read at a time on host. Outputs are bit-identical to the host path
(tests/test_sketch.py, tests/test_parity_readselection.py).

Batching (ONE compiled shape): reads are packed back-to-back into
(TILE_ROWS, TILE_LEN) u8 tiles separated by l-1 invalid bases, so k-mer
windows never span two reads; reads longer than a tile are split into
segments overlapping by l-1 bases (the window sets of consecutive segments
partition the read's windows exactly). Minimizer selection is per-window
local, so segment results stitch losslessly; the reference's 1-window end
trim (MinimizerParser::_trimBps, src/utils/kmer/Kmer.hpp:1362,1395) is
applied host-side on read-local window indices. A single static shape means
a single XLA compile instead of one per length bucket, and near-zero padding
waste on ragged read lengths. Upload is 2-bit packed (kernels/sketch.py
pack_codes); only the selected entries transfer back
(sketch_batch_compact_packed).
"""

import numpy as np

from ..constants import MINIMIZER_DTYPE

TILE_LEN = 16384       # bases per row; multiple of 8 (pack_codes)
TILE_ROWS = 512        # rows per device call (8 Mbp)


class BatchSketcher:
    """Sketches many reads at once on the default JAX device.

    Parameters mirror sketch/minimizers.select_minimizers; `repetitive` is a
    sorted u32 blacklist applied host-side after compaction (the selected
    set is ~density * bases, so the filter is cheap).
    """

    def __init__(self, l: int, density: float,
                 repetitive: np.ndarray | None = None):
        self.l = l
        self.density = float(density)
        self.repetitive = repetitive if repetitive is not None and \
            repetitive.size else None

    # -- tiling ----------------------------------------------------------
    def _pack(self, codes_list, bad_list):
        """Concatenate reads into (n_rows, TILE_LEN) tiles.

        Returns (tiles u8, segments) where segments[i] is a list of
        (row, col_start, seg_len, read_base_offset) for read i.
        """
        l = self.l
        sep = l - 1
        rows = [np.full(TILE_LEN, 4, np.uint8)]
        col = 0
        segments = [[] for _ in codes_list]

        def new_row():
            nonlocal col
            rows.append(np.full(TILE_LEN, 4, np.uint8))
            col = 0

        for i, codes in enumerate(codes_list):
            c = np.where(bad_list[i], 4, codes).astype(np.uint8)
            m = c.shape[0]
            off = 0
            while m - off > TILE_LEN:
                # long read: full-tile segment, next overlaps by l-1
                if col > 0:
                    new_row()
                rows[-1][:] = c[off: off + TILE_LEN]
                segments[i].append((len(rows) - 1, 0, TILE_LEN, off))
                new_row()
                off += TILE_LEN - (l - 1)
            rem = m - off
            if rem >= l:
                if col + rem > TILE_LEN:
                    new_row()
                rows[-1][col: col + rem] = c[off:]
                segments[i].append((len(rows) - 1, col, rem, off))
                col += rem + sep
                if col >= TILE_LEN:
                    new_row()
        return np.stack(rows), segments

    def sketch_many(self, codes_list, bad_list):
        """codes_list: list of u8 base-code arrays (RLE'd); bad_list: bool
        arrays marking non-ACGT bases. Returns a list of
        (minimizers u32, positions u32, directions u8), in input order."""
        from ..kernels import sketch as dsketch

        n = len(codes_list)
        tiles, segments = self._pack(codes_list, bad_list)
        nk = TILE_LEN - self.l + 1
        cap = dsketch.compact_cap(nk, self.density)
        lens = np.full(TILE_ROWS, TILE_LEN, np.int32)

        # device sweep over fixed-shape tile batches. Dispatch is async:
        # all batches are enqueued first (host packing overlaps device
        # compute), then materialized in order.
        n_rows = tiles.shape[0]
        pos_rows = [None] * n_rows
        val_rows = [None] * n_rows
        dir_rows = [None] * n_rows
        pending = []
        for s in range(0, n_rows, TILE_ROWS):
            batch = tiles[s: s + TILE_ROWS]
            if batch.shape[0] < TILE_ROWS:
                pad = np.full((TILE_ROWS - batch.shape[0], TILE_LEN), 4,
                              np.uint8)
                batch = np.concatenate([batch, pad])
            packed, bad_packed = dsketch.pack_codes(batch)
            res = dsketch.sketch_batch_compact_packed(
                packed, bad_packed, lens, self.l, self.density, cap)
            pending.append((s, batch, res))
        for s, batch, res in pending:
            counts = np.asarray(res["counts"])
            positions = np.asarray(res["positions"])
            values = np.asarray(res["values"])
            dirs = np.asarray(res["directions"])
            for r in range(min(TILE_ROWS, n_rows - s)):
                if counts[r] > cap:
                    # pathological row (tandem repeats of a selected k-mer):
                    # recompute on host from the tile row
                    from . import minimizers as hostmin
                    row = batch[r]
                    mins, pos, dd = hostmin.select_minimizers(
                        row, row >= 4, self.l, self.density, trim=0)
                    pos_rows[s + r] = pos.astype(np.int64)
                    val_rows[s + r] = mins.astype(np.uint32)
                    dir_rows[s + r] = dd
                else:
                    m = counts[r]
                    pos_rows[s + r] = positions[r, :m].astype(np.int64)
                    val_rows[s + r] = values[r, :m].astype(np.uint32)
                    dir_rows[s + r] = dirs[r, :m]

        # stitch per read, apply end trim + blacklist
        out = [None] * n
        for i in range(n):
            mins_parts, pos_parts, dir_parts = [], [], []
            for (row, col, seg_len, base_off) in segments[i]:
                p = pos_rows[row]
                lo = np.searchsorted(p, col)
                hi = np.searchsorted(p, col + seg_len - self.l, side="right")
                pos_parts.append(p[lo:hi] - col + base_off)
                mins_parts.append(val_rows[row][lo:hi])
                dir_parts.append(dir_rows[row][lo:hi])
            if pos_parts:
                pos = np.concatenate(pos_parts)
                vals = np.concatenate(mins_parts).astype(MINIMIZER_DTYPE)
                dd = np.concatenate(dir_parts)
            else:
                pos = np.zeros(0, np.int64)
                vals = np.zeros(0, MINIMIZER_DTYPE)
                dd = np.zeros(0, np.uint8)
            # _trimBps = 1: windows 0 and nk-1 of the whole read are never
            # selected (sketch/minimizers.py)
            nk_read = codes_list[i].shape[0] - self.l + 1
            keep = (pos >= 1) & (pos < nk_read - 1)
            pos, vals, dd = pos[keep], vals[keep], dd[keep]
            if self.repetitive is not None and vals.size:
                j = np.searchsorted(self.repetitive, vals)
                j = np.minimum(j, self.repetitive.size - 1)
                keep = self.repetitive[j] != vals
                vals, pos, dd = vals[keep], pos[keep], dd[keep]
            out[i] = (vals, pos.astype(np.uint32), dd)
        return out

