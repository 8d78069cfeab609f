"""Target minimizer index: an array-relational design.

Where minimap2 builds a bucketed hash table (`index.c`), the device
design is a *sorted postings array*: minimizer hashes sorted ascending
with parallel (rid, pos, strand) arrays.  Lookup is a batched binary
search (``searchsorted``) — branch-free, fully vectorisable, and
shardable across devices by hash range or by target shard.

The occurrence cutoff reproduces ``mm_idx_cal_max_occ`` +
``mm_mapopt_update`` (SURVEY.md C15): ``thres`` is the
``floor((1-f)*n_distinct)``-th smallest per-distinct-minimizer count
plus one, clamped to ``[min_mid_occ, max_mid_occ]``; query seeds whose
target occurrence exceeds ``mid_occ`` are dropped (the ava presets use
``-e0``, so no high-frequency sampling).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from ..platform import OverlapParams
from .encode import encode_seq
from .sketch import sketch_read


@dataclass
class TargetIndex:
    """Device-friendly sorted minimizer index over the target read set."""

    keys: np.ndarray  # [N] uint64 minimizer hash, sorted ascending
    rid: np.ndarray  # [N] int32 target read id
    pos: np.ndarray  # [N] int32 position of k-mer end on target
    strand: np.ndarray  # [N] int8
    names: list  # [T] target read names (bytes)
    lengths: np.ndarray  # [T] int32 target read lengths
    mid_occ: int
    params: OverlapParams
    # lexicographic order of names, used for the dual/self masks
    name_rank: np.ndarray = field(default=None)  # [T] int32

    @property
    def n_targets(self) -> int:
        return len(self.names)

    def occurrence(self, hashes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(start, count) of each query hash in the postings array."""
        start = np.searchsorted(self.keys, hashes, side="left")
        end = np.searchsorted(self.keys, hashes, side="right")
        return start, end - start


def calc_mid_occ(counts_per_distinct: np.ndarray, params: OverlapParams) -> int:
    """``mm_idx_cal_max_occ`` + the ``mm_mapopt_update`` clamps."""
    n = len(counts_per_distinct)
    if params.mid_occ_frac <= 0 or n == 0:
        return np.iinfo(np.int32).max
    kth = int((1.0 - params.mid_occ_frac) * n)
    kth = min(kth, n - 1)
    thres = int(np.partition(counts_per_distinct, kth)[kth]) + 1
    mid_occ = max(thres, params.min_mid_occ)
    if params.max_mid_occ > params.min_mid_occ:
        mid_occ = min(mid_occ, params.max_mid_occ)
    return mid_occ


def _sketch_reads_device(seqs, params, lengths):
    """Sketch many reads with the batched device kernel.

    Returns per-read (hash, pos, strand) arrays; rows that hit a sketch
    loop quirk or exceed capacity are recomputed with the exact host
    path, so results equal the per-read host sketch exactly.
    """
    from .encode import make_batches
    from .sketch import needs_scalar_sketch, sketch_read
    from .overlap_jax import sketch_many
    from ..utils.jaxcache import enable_cache

    enable_cache()
    import jax.numpy as jnp

    # Use EXACTLY the device engine's program shape (SUPER x B x L) so
    # this shares the one compiled sketch program instead of compiling
    # per ragged group.
    SUPER, B, L = 8, 128, 4096
    M = L // 2
    per_read = [None] * len(seqs)
    short_rows = [i for i, s in enumerate(seqs) if len(s) <= L]
    long_rows = [i for i, s in enumerate(seqs) if len(s) > L]
    for i in long_rows:
        mz = sketch_read(encode_seq(seqs[i]), params.k, params.w, False)
        per_read[i] = (
            (mz.key >> np.uint64(8)).astype(np.uint64),
            mz.pos.astype(np.int32),
            mz.strand.astype(np.int8),
        )
    batches = make_batches(
        [seqs[i] for i in short_rows],
        ids=short_rows,
        batch_size=B,
        pad_to=L,
        pow2_lengths=False,
        pad_batch=True,
    )
    for b in batches:
        if b.codes.shape[1] != L:
            pad = np.full((B, L - b.codes.shape[1]), 4, dtype=np.uint8)
            b.codes = np.concatenate([b.codes, pad], axis=1)
    for off in range(0, len(batches), SUPER):
        group = batches[off : off + SUPER]
        codes = np.full((SUPER, B, L), 4, dtype=np.uint8)
        lens = np.zeros((SUPER, B), dtype=np.int32)
        ids = np.full((SUPER, B), -1, dtype=np.int32)
        for g, batch in enumerate(group):
            codes[g] = batch.codes
            lens[g] = batch.lengths
            ids[g] = batch.ids
        mhash, mpos, mstrand, mcount = map(
            np.asarray,
            sketch_many(jnp.asarray(codes), jnp.asarray(lens), k=params.k, w=params.w),
        )
        for g in range(len(group)):
            for row in range(B):
                rid = ids[g, row]
                if rid < 0:
                    continue
                codes_row = codes[g, row, : lens[g, row]]
                if mcount[g, row] > M or needs_scalar_sketch(
                    codes_row, params.k, params.w, False
                ):
                    mz = sketch_read(codes_row, params.k, params.w, False)
                    per_read[rid] = (
                        (mz.key >> np.uint64(8)).astype(np.uint64),
                        mz.pos.astype(np.int32),
                        mz.strand.astype(np.int8),
                    )
                else:
                    cnt = mcount[g, row]
                    per_read[rid] = (
                        mhash[g, row, :cnt].astype(np.uint64),
                        mpos[g, row, :cnt].astype(np.int32),
                        mstrand[g, row, :cnt].astype(np.int8),
                    )
    return per_read


_SKETCH_PARAMS = None


def _sketch_worker_init(params):
    global _SKETCH_PARAMS
    _SKETCH_PARAMS = params


def _sketch_worker(seq: bytes):
    mz = sketch_read(
        encode_seq(seq), _SKETCH_PARAMS.k, _SKETCH_PARAMS.w, _SKETCH_PARAMS.hpc
    )
    return (
        (mz.key >> np.uint64(8)).astype(np.uint64),
        mz.pos.astype(np.int32),
        mz.strand.astype(np.int8),
    )


def _sketch_reads_parallel(seqs, params, workers: int = None):
    """Sketch reads across forked worker processes (exact host sketch).

    Index sketching is embarrassingly parallel.  The pool forks, so it
    must run before the JAX backend starts its threads; afterwards
    (``fork_unsafe``) the sketch runs serially.
    """
    import multiprocessing as mp
    import os
    from concurrent.futures import ProcessPoolExecutor

    from ..engine import fork_unsafe

    workers = workers or os.cpu_count() or 2
    if fork_unsafe():
        # fork after the JAX backend (or any thread) is live inherits
        # locked mutexes and can crash the child; sketch serially (the
        # per-read numpy sketch does not release the GIL long enough
        # for a thread pool to pay off)
        _sketch_worker_init(params)
        return [_sketch_worker(s) for s in seqs]
    ctx = mp.get_context("fork")
    try:
        with ProcessPoolExecutor(
            workers, mp_context=ctx, initializer=_sketch_worker_init, initargs=(params,)
        ) as pool:
            return list(pool.map(_sketch_worker, seqs, chunksize=64))
    except Exception as e:  # keep correctness if the pool misbehaves
        import logging

        logging.getLogger("lrge").warning(
            "parallel index sketching failed (%s); falling back to serial", e
        )
        _sketch_worker_init(params)
        return [_sketch_worker(s) for s in seqs]


def build_index(
    seqs: Sequence[bytes],
    names: Sequence[bytes],
    params: OverlapParams,
    device: str = "auto",
    threads: int = 8,
) -> TargetIndex:
    """Sketch all target reads and build the sorted postings index.

    ``device="auto"`` parallelises sketching across forked workers for
    large read sets; ``"device"`` sketches on the accelerator.  All
    paths produce identical indexes (quirk rows use the exact scalar
    oracle everywhere).
    """
    all_keys = []
    all_rid = []
    all_pos = []
    all_strand = []
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    per_read = None
    if device == "device":
        per_read = _sketch_reads_device(seqs, params, lengths)
    elif device == "auto":
        from .sketch import sketch_seqs_native

        res = sketch_seqs_native(seqs, params.k, params.w, params.hpc, threads)
        if res is not None:
            per_read = [
                (
                    (mz.key >> np.uint64(8)).astype(np.uint64),
                    mz.pos.astype(np.int32),
                    mz.strand.astype(np.int8),
                )
                for mz in res
            ]
        elif len(seqs) >= 2000 and threads > 1:
            per_read = _sketch_reads_parallel(seqs, params, workers=threads)
    if per_read is not None:
        for rid, entry in enumerate(per_read):
            key, pos, strand = entry
            if len(key) == 0:
                continue
            all_keys.append(key)
            all_rid.append(np.full(len(key), rid, dtype=np.int32))
            all_pos.append(pos)
            all_strand.append(strand)
        return _assemble_index(all_keys, all_rid, all_pos, all_strand, names, lengths, params)
    for rid, seq in enumerate(seqs):
        codes = encode_seq(seq)
        mz = sketch_read(codes, params.k, params.w, params.hpc)
        if len(mz.key) == 0:
            continue
        all_keys.append(mz.key >> np.uint64(8))  # index matches on hash only
        all_rid.append(np.full(len(mz.key), rid, dtype=np.int32))
        all_pos.append(mz.pos.astype(np.int32))
        all_strand.append(mz.strand.astype(np.int8))
    return _assemble_index(all_keys, all_rid, all_pos, all_strand, names, lengths, params)


def _assemble_index(all_keys, all_rid, all_pos, all_strand, names, lengths, params):
    if all_keys:
        keys = np.concatenate(all_keys)
        rid = np.concatenate(all_rid)
        pos = np.concatenate(all_pos)
        strand = np.concatenate(all_strand)
    else:
        keys = np.empty(0, dtype=np.uint64)
        rid = np.empty(0, dtype=np.int32)
        pos = np.empty(0, dtype=np.int32)
        strand = np.empty(0, dtype=np.int8)
    # sort by (hash, rid, pos): the per-read arrays are concatenated in
    # rid order with positions ascending, so ONE stable sort on the hash
    # preserves (rid, pos) within ties — much faster than lexsort on
    # multi-million-posting indices
    order = np.argsort(keys, kind="stable")
    keys, rid, pos, strand = keys[order], rid[order], pos[order], strand[order]
    # per-distinct counts for the occurrence cutoff, from run boundaries
    # of the sorted key array (no np.unique hashing pass)
    if len(keys):
        starts = np.flatnonzero(np.concatenate(([True], keys[1:] != keys[:-1])))
        counts = np.diff(np.concatenate((starts, [len(keys)])))
    else:
        counts = np.empty(0, dtype=np.int64)
    mid_occ = calc_mid_occ(counts, params)
    name_rank = np.argsort(np.argsort(np.array(names, dtype=object), kind="stable"), kind="stable")
    return TargetIndex(
        keys=keys,
        rid=rid,
        pos=pos,
        strand=strand,
        names=list(names),
        lengths=lengths,
        mid_occ=mid_occ,
        params=params,
        name_rank=name_rank.astype(np.int32),
    )
