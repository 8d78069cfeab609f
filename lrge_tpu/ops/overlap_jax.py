"""Batched on-device overlap counting (JAX).

The device pipeline for one query batch against a device-resident
index (the hot loop the reference spends ~all CPU time in, `mm_map` via
`aligner.rs:230-241`, recast as fixed-shape batched programs):

1. **Seed lookup** — batched binary search of query minimizer hashes in
   the sorted postings array; occurrence filter at ``mid_occ``.
2. **Anchor expansion** — fixed-capacity ``[B, A]`` anchor buffer filled
   by rank: anchor slot ``a`` maps to posting ``start[m] + (a -
   cum[m-1])`` via a per-row ``searchsorted`` over the occurrence
   prefix-sum.  No host ragged structures; overflow is reported so the
   caller can retry that row with a bigger bucket (or the exact host
   path).
3. **Chaining DP** — ``lax.scan`` over anchor slots with a ``W``-wide
   predecessor ring (newest-first), the same f32 gap penalty as the
   host reference (`ops/chain.py`), masks for same-(rid,strand), gap and
   band limits.
4. **Per-target reduction** — segmented max over rid runs (anchors are
   sorted by rid) with an associative scan; a target overlaps the query
   iff its best chain score reaches ``min_chain_score``.  For non-HPC
   presets ``min_cnt`` is implied (score >= 100 needs >= ceil(100/k) >=
   min_cnt anchors), so no count tracking is needed on device.

Counts are exact (equal to the host reference) whenever no anchor
buffer overflow occurs and ``W`` covers the densest predecessor window;
both conditions are reported per query so callers can fall back.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

# numpy (not jnp) scalars: creating a device array at import time would
# initialise the XLA backend, which breaks jax.distributed.initialize
# for any process that imports this module before joining the cluster
NEG = np.int32(np.iinfo(np.int32).min // 2)  # headroom to avoid overflow
IMAX = np.int32(np.iinfo(np.int32).max)

# pair-plane capacity: per-query passing-target lists are clipped to
# min(num_anchors, PAIR_CAP) slots — _reduce_counts and the lax.cond
# empty branches must agree on this width or tracing fails
PAIR_CAP = 512


def _gatherw(table: jnp.ndarray, idx: jnp.ndarray, w: int) -> jnp.ndarray:
    """Windowed gather: ``[..., w]`` consecutive entries starting at
    ``idx``.  Out-of-range starts are clamped to ``[0, len(table)-w]``
    (window-start shift), identically in BOTH lowerings; callers that
    care about positions must still pre-clip ``idx`` themselves.

    Two lowerings:

    * default — ``w`` separate gathers of ``table[idx+j]``.
    * ``LRGE_WIN_GATHER=1`` — ONE ``lax.gather`` of ``w``-wide slices,
      so consecutive elements can share a memory transaction.
    """
    import os as _os

    if _os.environ.get("LRGE_WIN_GATHER") == "1":
        flat = idx.reshape(-1, 1)
        out = jax.lax.gather(
            table,
            flat,
            jax.lax.GatherDimensionNumbers(
                offset_dims=(1,), collapsed_slice_dims=(), start_index_map=(0,)
            ),
            slice_sizes=(w,),
            mode=jax.lax.GatherScatterMode.CLIP,
        )
        return out.reshape(*idx.shape, w)
    start = jnp.clip(idx, 0, max(table.shape[0] - w, 0))
    cols = [table[start + j] for j in range(w)]
    return jnp.stack(cols, axis=-1)


def _unpack2bit(codes_p: jnp.ndarray, L: int) -> jnp.ndarray:
    """Expand 2-bit-packed base codes ``[..., L//4] uint8`` to
    ``[..., L] uint8`` (4 bases per byte, little-endian within the
    byte).  Ambiguity is NOT representable — the host packs ``code&3``
    and recomputes ambiguous-base rows exactly (the sketch-quirk
    triage runs on the UNPACKED host-side plane), so the device only
    ever needs ACGT + the length mask.  Packing quarters the
    host->device transfer for the dominant input plane."""
    shifts = jnp.arange(0, 8, 2, dtype=jnp.uint8)
    u = (codes_p[..., :, None] >> shifts) & jnp.uint8(3)
    return u.reshape(*codes_p.shape[:-1], codes_p.shape[-1] * 4)[..., :L]


def pack2bit_host(codes: np.ndarray) -> np.ndarray:
    """Host-side packer matching :func:`_unpack2bit` (numpy, code&3;
    the length axis must be a multiple of 4)."""
    c = codes & 3
    return (
        c[..., 0::4]
        | (c[..., 1::4] << 2)
        | (c[..., 2::4] << 4)
        | (c[..., 3::4] << 6)
    ).astype(np.uint8)


def mg_log2_jax(x: jnp.ndarray) -> jnp.ndarray:
    """minimap2's fast f32 log2 (bit trick), matching chain.mg_log2."""
    bits = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
    log2 = ((bits >> 23) & 255).astype(jnp.float32) - 128.0
    bits = (bits & jnp.uint32(~np.uint32(255 << 23))) + jnp.uint32(127 << 23)
    zf = jax.lax.bitcast_convert_type(bits, jnp.float32)
    return log2 + (jnp.float32(-0.34484843) * zf + jnp.float32(2.02466578)) * zf - jnp.float32(
        0.67487759
    )



def gap_penalty_jax(dd: jnp.ndarray, pen_gap: jnp.ndarray) -> jnp.ndarray:
    """Chain gap penalty ``int(pen_gap*dd + 0.5*log2(dd+1))`` in f32,
    matching the host DP's :func:`~lrge_tpu.ops.chain.gap_penalty` bit
    for bit (a one-ulp difference can move a chain score across
    ``min_chain_score``)."""
    lin = pen_gap * dd.astype(jnp.float32)
    logp = jnp.where(dd >= 1, mg_log2_jax((dd + 1).astype(jnp.float32)), 0.0)
    return (lin + jnp.float32(0.5) * logp).astype(jnp.int32)


def minimizer_cap(L: int) -> int:
    """Minimizer-slot capacity for padded read length ``L``.

    Expected density is 2/(w+1) (~L/3 at w=5); 2L/5 leaves ~20%% slack
    for tie emission.  Reads that exceed the cap are detected exactly
    (``mcount`` > cap) and recomputed on the host, so this is a
    performance knob, not a correctness bound.  Rounded to the 128-lane
    tile.
    """
    return max(128, ((2 * L // 5) + 127) // 128 * 128)

def _q_occ_drop_narrow(mhash, mid_occ, q_occ_frac):
    """mm_seed_mz_flt for single-plane (uint32) query hashes.

    Drop query minimizers occurring > mid_occ times within the query
    itself AND > q_occ_frac of the query's minimizer count; inactive
    unless the query has > mid_occ minimizers.  Sort-based run-length
    count (no scatters): sort (hash, slot), distribute run lengths
    with a segmented scan, then restore slot order with a second sort.
    Purely query-side (no index dependence), so shardable paths can
    compute it once and reuse it against every index shard.
    """
    B, M = mhash.shape
    slot_ids = jnp.broadcast_to(jnp.arange(M, dtype=jnp.int32)[None, :], (B, M))
    sh, sslot = jax.lax.sort((mhash, slot_ids), dimension=1, num_keys=1, is_stable=True)
    newrun = jnp.concatenate(
        [jnp.ones((B, 1), dtype=bool), sh[:, 1:] != sh[:, :-1]], axis=1
    )
    pos = jnp.broadcast_to(jnp.arange(M, dtype=jnp.int32)[None, :], (B, M))

    # run starts broadcast forward / run ends backward with native
    # cumulative ops (positions are monotone; the unrolled
    # associative_scan this replaces dominated HLO size)
    run_start = jax.lax.cummax(jnp.where(newrun, pos, -1), axis=1)
    runend_flag = jnp.concatenate(
        [sh[:, 1:] != sh[:, :-1], jnp.ones((B, 1), dtype=bool)], axis=1
    )
    run_end = jax.lax.cummin(
        jnp.where(runend_flag, pos, IMAX), axis=1, reverse=True
    )
    run_cnt = run_end - run_start + 1
    _, cnt_by_slot = jax.lax.sort((sslot, run_cnt), dimension=1, num_keys=1, is_stable=True)
    n_mini = jnp.sum(mhash != jnp.uint32(0xFFFFFFFF), axis=1).astype(jnp.int32)
    return (
        (n_mini[:, None] > mid_occ)
        & (cnt_by_slot > mid_occ)
        & (
            cnt_by_slot.astype(jnp.float32)
            > n_mini[:, None].astype(jnp.float32) * jnp.float32(q_occ_frac)
        )
    )


def _q_occ_drop_wide(qhi, qlo, pad, mid_occ, q_occ_frac):
    """mm_seed_mz_flt for two-plane (wide/HPC) query hashes."""
    B, M = qhi.shape
    slot_ids = jnp.broadcast_to(jnp.arange(M, dtype=jnp.int32)[None, :], (B, M))
    shi = jnp.where(pad, IMAX, qhi)
    slo = jnp.where(pad, IMAX, qlo)
    shi_s, slo_s, sslot = jax.lax.sort(
        (shi, slo, slot_ids), dimension=1, num_keys=2, is_stable=True
    )
    samerun = (shi_s[:, 1:] == shi_s[:, :-1]) & (slo_s[:, 1:] == slo_s[:, :-1])
    newrun = jnp.concatenate([jnp.ones((B, 1), dtype=bool), ~samerun], axis=1)
    pos = jnp.broadcast_to(jnp.arange(M, dtype=jnp.int32)[None, :], (B, M))

    run_start = jax.lax.cummax(jnp.where(newrun, pos, -1), axis=1)
    runend_flag = jnp.concatenate([~samerun, jnp.ones((B, 1), dtype=bool)], axis=1)
    run_end = jax.lax.cummin(
        jnp.where(runend_flag, pos, IMAX), axis=1, reverse=True
    )
    run_cnt = run_end - run_start + 1
    _, cnt_by_slot = jax.lax.sort(
        (sslot, run_cnt), dimension=1, num_keys=1, is_stable=True
    )
    n_mini = jnp.sum(~pad, axis=1).astype(jnp.int32)
    return (
        (n_mini[:, None] > mid_occ)
        & (cnt_by_slot > mid_occ)
        & (
            cnt_by_slot.astype(jnp.float32)
            > n_mini[:, None].astype(jnp.float32) * jnp.float32(q_occ_frac)
        )
    )


def _pb_probe(qhi, qlo, uh_hi, uh_lo, boff, *, hash_bits, bucket_bits, bucket_kmax):
    """Bucketed dictionary probe for two-plane (wide) hashes: unique-hash
    slot per minimizer (-1 miss).  Pure probe — occurrence/padding/q_occ
    gates are the caller's job."""
    B, M = qhi.shape
    shift = hash_bits - bucket_bits
    if shift >= _PB_SPLIT:
        ub = qhi >> (shift - _PB_SPLIT)
    else:
        ub = (qhi << (_PB_SPLIT - shift)) | (qlo >> shift)
    ub = jnp.clip(ub, 0, (1 << bucket_bits) - 1)
    bo = _gatherw(boff, ub, 2)
    b0, b1 = bo[..., 0], bo[..., 1]
    U = uh_hi.shape[0]
    K = bucket_kmax
    # windowed probe fetch (see _dict_lookup): one slice per plane
    cstart = jnp.clip(b0, 0, max(U - K, 0))
    win_hi = _gatherw(uh_hi, cstart, K)
    win_lo = _gatherw(uh_lo, cstart, K)
    pos = cstart[..., None] + jnp.arange(K, dtype=jnp.int32)
    hit = (
        (pos >= b0[..., None])
        & (pos < b1[..., None])
        & (win_hi == qhi[..., None])
        & (win_lo == qlo[..., None])
    )
    return jnp.max(jnp.where(hit, pos, -1), axis=-1)


def map_batch_core(
    idx_keys: jnp.ndarray,  # [N] int32 (hash ^ 0x80000000, sorted)
    idx_rid: jnp.ndarray,  # [N] int32
    idx_pos: jnp.ndarray,  # [N] int32
    idx_strand: jnp.ndarray,  # [N] int32
    idx_rank: jnp.ndarray,  # [T] int32 lexicographic name rank
    mid_occ: jnp.ndarray,  # scalar int32
    mhash: jnp.ndarray,  # [B, M] uint32 (0xFFFFFFFF padding)
    mpos: jnp.ndarray,  # [B, M] int32
    mstrand: jnp.ndarray,  # [B, M] int32
    qlen: jnp.ndarray,  # [B] int32
    qdualrank: jnp.ndarray,  # [B] int32
    qselfrid: jnp.ndarray,  # [B] int32 (-1 = not a target)
    chn_pen_gap: jnp.ndarray,  # f32 scalar
    uhash: jnp.ndarray = None,  # [U] int32 unique transformed hashes
    uoff: jnp.ndarray = None,  # [U+1] int32 posting offsets per unique hash
    boff: jnp.ndarray = None,  # [2^bits+1] int32 unique-hash offsets per bucket
    *,
    k: int,
    max_gap: int,
    bw: int,
    min_score: int,
    num_anchors: int,
    window: int,
    no_dual: bool,
    no_diag: bool,
    max_chain_skip: int = 25,
    q_occ_frac: float = 0.01,
    bucket_bits: int = 0,
    bucket_kmax: int = 8,
    packed_pos: bool = False,
):
    """Returns ``(counts [B], n_anchors [B], best_f [B,A], rid_sorted
    [B,A])``; ``n_anchors`` > ``num_anchors`` flags overflow."""
    B, M = mhash.shape
    N = idx_keys.shape[0]
    A = num_anchors
    W = window

    # ---- 1. lookup ----
    qk = jax.lax.bitcast_convert_type(mhash ^ jnp.uint32(0x80000000), jnp.int32)
    if bucket_bits > 0:
        # bucketed hash dictionary: O(KMAX) gathers per minimizer
        # instead of two full binary searches over the postings array
        hash_bits = 2 * k
        nb = 1 << bucket_bits
        ub = jnp.minimum(mhash >> (hash_bits - bucket_bits), jnp.uint32(nb - 1)).astype(
            jnp.int32
        )
        b0 = boff[ub]
        b1 = boff[ub + 1]
        U = uhash.shape[0]
        found = jnp.full((B, M), -1, dtype=jnp.int32)
        for j in range(bucket_kmax):
            pos = b0 + j
            ok = pos < b1
            val = uhash[jnp.minimum(pos, U - 1)]
            hit = ok & (val == qk)
            found = jnp.where(hit, pos, found)
        foundc = jnp.maximum(found, 0)
        start = uoff[foundc]
        occ = jnp.where(found >= 0, uoff[foundc + 1] - start, 0).astype(jnp.int32)
    else:
        start = jnp.searchsorted(idx_keys, qk.ravel(), side="left").reshape(B, M)
        end = jnp.searchsorted(idx_keys, qk.ravel(), side="right").reshape(B, M)
        occ = (end - start).astype(jnp.int32)
    occ = jnp.where(occ > mid_occ, 0, occ)
    # invalid minimizer slots (0xFFFFFFFF padding) must never match,
    # even when the index itself is padded with sentinel keys
    occ = jnp.where(mhash == jnp.uint32(0xFFFFFFFF), 0, occ)

    # ---- q_occ filter (mm_seed_mz_flt) ----
    if q_occ_frac > 0:
        occ = jnp.where(_q_occ_drop_narrow(mhash, mid_occ, q_occ_frac), 0, occ)

    mps = mpos * 2 + mstrand
    return _expand_sort_chain(
        start,
        occ,
        mps,
        qlen,
        qdualrank,
        qselfrid,
        idx_rid,
        idx_pos,
        idx_strand,
        idx_rank,
        chn_pen_gap,
        k=k,
        max_gap=max_gap,
        bw=bw,
        min_score=min_score,
        num_anchors=num_anchors,
        window=window,
        no_dual=no_dual,
        no_diag=no_diag,
        max_chain_skip=max_chain_skip,
        packed_pos=packed_pos,
    )


def _expand_sort_chain(
    start,  # [B, M] int32: first posting index per minimizer
    occ,  # [B, M] int32: posting count per minimizer (0 = none)
    mps,  # [B, M] int32: query end-pos*2 | strand
    qlen,
    qdualrank,
    qselfrid,
    idx_rid,
    idx_pos,
    idx_strand,
    idx_rank,
    chn_pen_gap,
    *,
    k,
    max_gap,
    bw,
    min_score,
    num_anchors,
    window,
    no_dual,
    no_diag,
    max_chain_skip,
    packed_pos,
    with_spans=False,
    min_cnt=3,
    want_pairs=True,
    packed_rid_bits=0,
    want_extents=False,
    overhang_ratio=0.2,
    filter_mode="internal",
    idx_tlen=None,
    dp_chunk=1,
    profile_stage="",
    rank_postings=False,
):
    """Anchor expansion + (rid,strand,rpos) sort + chain DP + reduce.

    ``rank_postings``: the posting plane carries name RANKS instead of
    rids (GroupedDeviceIndex/ShardedGroupedIndex layouts) — the
    MM_F_NO_DUAL gate then compares the plane value directly and the
    per-anchor rank gather disappears; callers must pass ``qselfrid``
    in rank space and translate pair outputs back.

    ``profile_stage`` ("expand" | "sort" | "dp") truncates the pipeline
    right after the named stage, returning checksum-shaped dummies —
    a measurement knob (``chip_smoke.py`` reads the chain DP's share of
    a dispatch from it) so on-chip stage costs can be measured without
    duplicating the pipeline; keep "" for production.

    ``want_extents`` (constant-span presets only) additionally tracks
    each chain's START coordinates, anchor count, and a deep-valley
    flag through the DP, so the reduce can apply the reference's ``-F``
    overhang filter per passing target on device.  ``filter_mode``
    picks the comparison: ``"internal"`` drops internal matches
    (`mapping.rs:59-77`, the forward two-set/ava paths) and
    ``"overhang"`` drops overhang-heavy matches (the inverted
    comparison of the ``--use-min-ref`` path, `twoset.rs:493-517`).
    Rows whose decision could differ from the exact host backtrack
    (dropped best chain with a possible passing secondary, or a valley
    the backtrack would trim) are flagged for host recompute via the
    ``max_run`` channel.

    Shared tail of the device pipeline: callers provide the per-query
    posting ranges however they were looked up (inline dictionary in
    ``map_batch_core``; precomputed ``found`` planes in
    ``map_found_core``).  With ``packed_rid_bits`` > 0, ``idx_rid`` is a
    single packed plane ``rid<<(1+bits) | pos<<1 | strand`` and
    ``idx_pos``/``idx_strand`` are ignored (ONE posting gather)."""
    B, M = occ.shape
    N = idx_rid.shape[0]
    A = num_anchors
    W = window

    # ---- 2. anchor expansion ----
    # random access dominates this stage, so the expansion uses TWO
    # [B, M]-update scatters (one per per-anchor attribute) and a log-depth gap fill,
    # with ZERO [B, A] gathers.  Each live minimizer drops ``adj`` (its
    # posting-offset arithmetic folded into one i32, biased +A+1 so
    # every scattered value is >= 1) and ``mps`` (query pos/strand,
    # biased +1) at its first anchor slot — live prev_cums are strictly
    # increasing, so the scatters are collision-free and non-live lanes
    # scatter 0 into slot 0, discarded by max — then a doubling
    # fill-forward replicates each run-start value across its
    # [prev_cum, cum) range (every anchor slot < total belongs to some
    # run, so "nearest earlier nonzero" is exactly the owner).  This
    # needs no [B, A]<-[B, M] gathers at all.
    cum = jnp.cumsum(occ, axis=1)
    total = cum[:, -1]
    slots = jnp.arange(A, dtype=jnp.int32)
    prev_cum = cum - occ
    live = (occ > 0) & (prev_cum < A)
    tgt = jnp.where(live, prev_cum, 0)
    rows = jnp.arange(B, dtype=jnp.int32)[:, None]
    adj = start - cum + occ  # >= -A (start >= 0, prev_cum <= A)
    OFF = jnp.int32(A + 1)
    s_adj = jnp.zeros((B, A), jnp.int32).at[rows, tgt].max(
        jnp.where(live, adj + OFF, 0)
    )
    s_mps = jnp.zeros((B, A), jnp.int32).at[rows, tgt].max(
        jnp.where(live, mps + 1, 0)
    )

    def _fill_forward(x):
        # nearest earlier nonzero, log2(A) shift+select passes
        d = 1
        while d < A:
            sh = jnp.pad(x[:, :-d], ((0, 0), (d, 0)))
            x = jnp.where(x == 0, sh, x)
            d *= 2
        return x

    adj_f = _fill_forward(s_adj) - OFF
    mps_f = _fill_forward(s_mps) - 1
    valid = slots[None, :] < jnp.minimum(total, A)[:, None]
    p_idx = slots[None, :] + adj_f
    p_idx = jnp.clip(p_idx, 0, max(N - 1, 0))

    if packed_rid_bits:
        pr = idx_rid[p_idx]  # the packed plane: ONE [B, A] gather
        rid = jnp.where(valid, pr >> (1 + packed_rid_bits), IMAX)
        rpos = jnp.where(valid, (pr >> 1) & ((1 << packed_rid_bits) - 1), 0)
        tstrand = pr & 1
    elif packed_pos:
        rid = jnp.where(valid, idx_rid[p_idx], IMAX)
        pp = idx_pos[p_idx]
        rpos = jnp.where(valid, pp >> 1, 0)
        tstrand = pp & 1
    else:
        rid = jnp.where(valid, idx_rid[p_idx], IMAX)
        rpos = jnp.where(valid, idx_pos[p_idx], 0)
        tstrand = idx_strand[p_idx]
    mps_a = mps_f
    qstr = mps_a & 1
    strand = jnp.where(valid, tstrand ^ qstr, 0)
    if with_spans:
        # HPC presets: per-minimizer span packed as pos<<9 | span<<1 | strand
        span_a = (mps_a >> 1) & 255
        mq = mps_a >> 9
        qpos_fwd = mq
        qpos_rev = qlen[:, None] - mq + span_a - 2
    else:
        span_a = None
        mq = mps_a >> 1
        qpos_fwd = mq
        qpos_rev = qlen[:, None] - mq + (k - 2)
    qpos = jnp.where(strand == 0, qpos_fwd, qpos_rev)

    # ---- masks (MM_F_NO_DUAL / no-diag, aligner.rs:89-103) ----
    drop = jnp.zeros((B, A), dtype=bool)
    if no_dual:
        if rank_postings:
            # the plane value IS the name rank: no gather
            drop = drop | (valid & (rid < qdualrank[:, None]))
        else:
            rank = idx_rank[jnp.clip(rid, 0, idx_rank.shape[0] - 1)]
            drop = drop | (valid & (rank < qdualrank[:, None]))
    if no_diag:
        drop = drop | (
            valid
            & (rid == qselfrid[:, None])
            & (strand == 0)
            & (rpos == qpos)
        )
    valid = valid & ~drop
    # pre-mask expansion size: rows with total > A were truncated and
    # must be retried with a larger bucket / host path
    n_anchors = total

    rid = jnp.where(valid, rid, IMAX)
    key2 = jnp.where(valid, rid * 2 + strand, IMAX)
    if with_spans:
        # carry the span through the sort inside the qpos payload
        qpos = (qpos << 8) | span_a

    PM_prof = min(num_anchors, PAIR_CAP) if want_pairs else 1
    _dummy_pairs = jnp.full((B, PM_prof), -1, jnp.int32)
    if profile_stage == "expand":
        chk = jnp.sum(key2 + rpos + qpos, axis=1, dtype=jnp.int32)
        return chk, n_anchors, jnp.zeros((B,), jnp.int32), _dummy_pairs

    # ---- sort by (rid,strand,rpos), stable in seed order ----
    # rid rides inside the key (key2 = rid*2+strand, IMAX when invalid),
    # so it is NOT a separate sort operand; derive it after the sort
    key2_s, rpos_s, qpos_s = jax.lax.sort(
        (key2, rpos, qpos), dimension=1, num_keys=2, is_stable=True
    )
    valid_s = key2_s != IMAX
    rid_s = jnp.where(valid_s, key2_s >> 1, IMAX)

    if profile_stage == "sort":
        chk = jnp.sum(key2_s + rpos_s + qpos_s, axis=1, dtype=jnp.int32)
        return chk, n_anchors, jnp.zeros((B,), jnp.int32), _dummy_pairs

    # ---- 3. chaining DP ----
    # single-anchor step: one anchor of all B queries per step, with a
    # W-deep newest-first predecessor ring in the carry; the while_loop
    # below runs ``dp_chunk`` steps per trip.
    # The max_chain_skip early-break is modelled exactly without scan
    # state: for the descending predecessor scan of anchor i,
    #   * "already examined" anchors are simply those at earlier
    #     descending positions,
    #   * the floored skip counter is the Lindley recursion
    #     n_t = max(0, n_{t-1} + a_t) = S_t - min(0, min_{s<=t} S_s)
    #     over steps a_t = +1 (valid, marked, non-improving) /
    #     -1 (improving), so the break position falls out of cumulative
    #     sums/minima along the window axis,
    #   * "marked" (j is the stored predecessor of an examined valid
    #     anchor) is a one-hot compare of predecessor links against
    #     window positions.
    span = jnp.int32(k)
    pen_gap = chn_pen_gap.astype(jnp.float32)

    def pair_sc(ck, cr, cq, pk, pr, pq, pf):
        """(cand, ok) of transitioning from predecessors p* to current c*.

        Shapes broadcast: current [B, 1] or [B], predecessors [B, W'].
        With spans, cq/pq carry ``qpos<<8 | span`` and the score uses
        the PREDECESSOR's span (minimap2 ``comput_sc``: min(dg, q_span
        of j)).  Validity rides in the key: invalid anchors carry
        ``IMAX`` keys (the sort's padding), so ``pk != IMAX & pk == ck``
        implies both ends valid with no separate ok buffer."""
        if with_spans:
            cqp, pqp = cq >> 8, pq >> 8
            psp = pq & 255
        else:
            cqp, pqp = cq, pq
            psp = span
        dq = cqp - pqp
        dr = cr - pr
        dd = jnp.abs(dr - dq)
        dg = jnp.minimum(dq, dr)
        sc = jnp.minimum(dg, psp)
        pen = gap_penalty_jax(dd, pen_gap)
        sc = jnp.where((dd != 0) | (dg > psp), sc - pen, sc)
        ok = (
            (pk != IMAX)
            & (pk == ck)
            & (dq > 0)
            & (dq <= max_gap)
            & (dr > 0)
            & (dr <= max_gap)
            & (dd <= bw)
        )
        return jnp.where(ok, sc + pf, NEG), ok

    dpos = jnp.arange(W, dtype=jnp.int32)

    track_cnt = with_spans or want_extents

    def step(carry, xs):
        carry = list(carry)
        ring_key, ring_rpos, ring_qpos, ring_f, ring_p = carry[:5]
        rest = carry[5:]
        ring_cnt = rest.pop(0) if track_cnt else None
        ring_sq = rest.pop(0) if want_extents else None
        ring_rmf = rest.pop(0) if want_extents else None
        ck, cr, cq, cv, islot = xs  # each [B]
        cspan = (cq & 255) if with_spans else span
        cand, ok = pair_sc(
            ck[:, None], cr[:, None], cq[:, None],
            ring_key, ring_rpos, ring_qpos, ring_f,
        )
        # marked[d]: some valid x at position d' holds p[x] == slot(d).
        # p_rel = islot-1-p maps link targets to descending positions;
        # p < slot(x) always, so p_rel[d'] > d' and no triangle mask
        # is needed.  p == -1 maps to islot (>= W), never matching.
        # Bit-packed one-hot votes OR-reduced over the ring axis keep
        # the step at [B, W] instead of materialising a [B, W, W]
        # one-hot every scan iteration.
        p_rel = islot[:, None] - 1 - ring_p  # [B, W]
        marked = jnp.zeros((B, W), dtype=bool)
        for b0 in range(0, W, 32):
            sh = p_rel - b0
            inplane = ok & (sh >= 0) & (sh < 32)
            vote = jnp.where(
                inplane,
                jnp.left_shift(jnp.uint32(1), (sh & 31).astype(jnp.uint32)),
                jnp.uint32(0),
            )
            votes = jax.lax.reduce(vote, np.uint32(0), jax.lax.bitwise_or, (1,))
            bitidx = dpos[None, :] - b0
            bit = (
                jnp.right_shift(votes[:, None], (bitidx & 31).astype(jnp.uint32))
                & jnp.uint32(1)
            ) != 0
            marked = marked | ((bitidx >= 0) & (bitidx < 32) & bit)
        # improving[d]: cand beats the running max of examined
        # predecessors (seeded with span); exclusive cummax suffices
        # because positions after the break never matter.  Native
        # cumulative ops (lax.cummax/cummin/cumsum) keep the HLO
        # graph small — associative_scan unrolls into huge graphs
        # at these widths and wrecks compile time.
        cmax = jax.lax.cummax(cand, axis=1)
        runmax_excl = jnp.concatenate(
            [jnp.full((B, 1), NEG, jnp.int32), cmax[:, :-1]], axis=1
        )
        runmax_excl = jnp.maximum(
            runmax_excl, cspan[:, None] if with_spans else span
        )
        improving = ok & (cand > runmax_excl)
        # Lindley skip counter and break position
        a_step = (ok & marked & ~improving).astype(jnp.int32) - improving.astype(
            jnp.int32
        )
        s_cum = jax.lax.cumsum(a_step, axis=1)
        runmin = jnp.minimum(jax.lax.cummin(s_cum, axis=1), 0)
        n_skip = s_cum - runmin
        over = n_skip > max_chain_skip
        overed = jax.lax.cummax(over.astype(jnp.int32), axis=1).astype(bool)
        # the breaking step itself is examined (its increment ran);
        # everything strictly after the first break is not
        broken_before = jnp.concatenate(
            [jnp.zeros((B, 1), bool), overed[:, :-1]], axis=1
        )
        cand = jnp.where(broken_before, NEG, cand)
        best = jnp.max(cand, axis=1)
        # ties keep the first descending position (largest j)
        bestd = jnp.argmax(cand, axis=1).astype(jnp.int32)
        has_pred = best > cspan if with_spans else best > span
        p_t = jnp.where(cv & has_pred, islot - 1 - bestd, -1)
        f_t = jnp.where(cv, jnp.maximum(cspan if with_spans else span, best), NEG)
        # chain anchor count: 1 + count at the chosen predecessor (the
        # HPC preset needs the min_cnt gate; the -F extent path needs it
        # for the secondary-chain bound; other presets imply it via
        # min_chain_score and skip the bookkeeping)
        onehot = dpos[None, :] == bestd[:, None]
        if track_cnt:
            cnt_prev = jnp.sum(jnp.where(onehot, ring_cnt, 0), axis=1)
            c_t = jnp.where(cv, jnp.where(has_pred, cnt_prev + 1, 1), 0)
        else:
            c_t = cv.astype(jnp.int32)  # unused
        if want_extents:
            # chain start coords (packed rpos<<16 | qpos of the FIRST
            # anchor) and the running-max/valley flag: a chain whose f
            # dips more than bw below its running max is one the exact
            # backtrack would trim (mg_chain_bk_end), so the row must be
            # flagged for host recompute
            sq_prev = jnp.sum(jnp.where(onehot, ring_sq, 0), axis=1)
            start_self = (cr << 16) | cq
            s_t = jnp.where(
                cv, jnp.where(has_pred, sq_prev, start_self), 0
            )
            rmf_prev = jnp.sum(jnp.where(onehot, ring_rmf, 0), axis=1)
            prevmax = rmf_prev >> 1
            vflag = (rmf_prev & 1) | (
                has_pred & ((prevmax - f_t) > bw)
            ).astype(jnp.int32)
            newmax = jnp.maximum(prevmax, f_t)
            rm_t = jnp.where(
                cv,
                jnp.where(has_pred, (newmax << 1) | vflag, f_t << 1),
                0,
            )
        else:
            s_t = rm_t = None
        # the scan broke inside the visible window: the result is
        # exact even if the (rid,strand) run extends beyond it
        b_t = overed[:, -1] & cv
        new_carry = (
            jnp.concatenate([ck[:, None], ring_key[:, : W - 1]], axis=1),
            jnp.concatenate([cr[:, None], ring_rpos[:, : W - 1]], axis=1),
            jnp.concatenate([cq[:, None], ring_qpos[:, : W - 1]], axis=1),
            jnp.concatenate([f_t[:, None], ring_f[:, : W - 1]], axis=1),
            jnp.concatenate([p_t[:, None], ring_p[:, : W - 1]], axis=1),
        )
        if track_cnt:
            new_carry = new_carry + (
                jnp.concatenate([c_t[:, None], ring_cnt[:, : W - 1]], axis=1),
            )
        if want_extents:
            new_carry = new_carry + (
                jnp.concatenate([s_t[:, None], ring_sq[:, : W - 1]], axis=1),
                jnp.concatenate([rm_t[:, None], ring_rmf[:, : W - 1]], axis=1),
            )
        return new_carry, (f_t, b_t, c_t, s_t, rm_t)

    init = (
        jnp.full((B, W), IMAX, dtype=jnp.int32),
        jnp.zeros((B, W), dtype=jnp.int32),
        jnp.zeros((B, W), dtype=jnp.int32),
        jnp.full((B, W), NEG, dtype=jnp.int32),
        jnp.full((B, W), -1, dtype=jnp.int32),
    )
    if track_cnt:
        init = init + (jnp.zeros((B, W), dtype=jnp.int32),)
    if want_extents:
        init = init + (
            jnp.zeros((B, W), dtype=jnp.int32),
            jnp.zeros((B, W), dtype=jnp.int32),
        )

    # dynamic trip count: invalid anchors sort to the end, so the DP
    # only needs to walk slots [0, max-valid-anchors-in-batch); the
    # remaining slots keep their init values (f = NEG, broke/cnt = 0),
    # which is exactly what the scan would have produced for all-invalid
    # steps.  Batches are length-sorted upstream, so the bound is tight
    # for short-read groups (mean anchors ~1/3 of capacity on the bench
    # corpus).
    C = max(1, int(dp_chunk))
    AP = A + C - 1  # chunk overrun pad: extra slots are invalid no-ops
    pad_rows = lambda x, fill: (
        jnp.concatenate(
            [x, jnp.full((C - 1, B), fill, x.dtype)], axis=0
        ) if C > 1 else x
    )
    xs_k = pad_rows(key2_s.T, IMAX)  # [AP, B]
    xs_r = pad_rows(rpos_s.T, 0)
    xs_q = pad_rows(qpos_s.T, 0)
    xs_v = pad_rows(valid_s.T, False)
    bound = jnp.minimum(jnp.max(jnp.sum(valid_s, axis=1)), A).astype(jnp.int32)
    f_buf = jnp.full((AP, B), NEG, jnp.int32)
    b_buf = jnp.zeros((AP, B), bool)
    c_buf = jnp.zeros((AP, B), jnp.int32)
    s_buf = jnp.zeros((AP, B), jnp.int32)
    r_buf = jnp.zeros((AP, B), jnp.int32)

    def cond_fn(state):
        return state[0] < bound

    def body_fn(state):
        i, carry, f_b, b_b, c_b, s_b, r_b = state
        # process C consecutive anchors per trip: the step body is
        # latency-bound at [B, W] shapes, so amortising the while_loop
        # iteration across C anchors trades HLO size for wall time
        for j in range(C):
            ii = i + j
            xk = jax.lax.dynamic_slice_in_dim(xs_k, ii, 1, 0)[0]
            xr = jax.lax.dynamic_slice_in_dim(xs_r, ii, 1, 0)[0]
            xq = jax.lax.dynamic_slice_in_dim(xs_q, ii, 1, 0)[0]
            xv = jax.lax.dynamic_slice_in_dim(xs_v, ii, 1, 0)[0]
            islot = jnp.broadcast_to(ii, (B,)).astype(jnp.int32)
            carry, (f_t, b_t, c_t, s_t, rm_t) = step(
                carry, (xk, xr, xq, xv, islot)
            )
            f_b = jax.lax.dynamic_update_slice_in_dim(f_b, f_t[None], ii, 0)
            b_b = jax.lax.dynamic_update_slice_in_dim(b_b, b_t[None], ii, 0)
            if track_cnt:  # chain anchor counts (min_cnt gate / -F bound)
                c_b = jax.lax.dynamic_update_slice_in_dim(c_b, c_t[None], ii, 0)
            if want_extents:
                s_b = jax.lax.dynamic_update_slice_in_dim(s_b, s_t[None], ii, 0)
                r_b = jax.lax.dynamic_update_slice_in_dim(r_b, rm_t[None], ii, 0)
        return (i + C, carry, f_b, b_b, c_b, s_b, r_b)

    _, _, f_steps, b_steps, c_steps, s_steps, r_steps = jax.lax.while_loop(
        cond_fn, body_fn, (jnp.int32(0), init, f_buf, b_buf, c_buf, s_buf, r_buf)
    )
    f = f_steps[:A].T  # [B, A]
    broke = b_steps[:A].T  # [B, A]
    if profile_stage == "dp":
        chk = jnp.sum(f + broke, axis=1, dtype=jnp.int32)
        return chk, n_anchors, jnp.zeros((B,), jnp.int32), _dummy_pairs
    extents = None
    if want_extents:
        extents = dict(
            starts=s_steps[:A].T, rmf=r_steps[:A].T, rpos=rpos_s, qpos=qpos_s,
            qlen=qlen, idx_tlen=idx_tlen, ratio=overhang_ratio, span=k,
            cnt=c_steps[:A].T, mode=filter_mode,
        )
    return _reduce_counts(
        f, broke, rid_s, key2_s, valid_s, n_anchors, B, A, W, min_score,
        cnt=c_steps[:A].T if with_spans else None, min_cnt=min_cnt,
        want_pairs=want_pairs, extents=extents,
    )


def _seg_best(f, boundary, A, B, want_slot):
    """Segmented best-score (and argmax slot) over rid runs, scan-free.

    A monotone run id packed above the (clipped) score turns the
    segmented max into ONE native ``cummax`` — read at run ends, every
    prefix max is the run's max (the unrolled ``associative_scan`` this
    replaces dominated both HLO size and reduce runtime).  With
    ``want_slot``, positions equal to their running max are "records";
    a second run-id-packed cummax over record slots yields, at each run
    end, the LARGEST slot among max-score ties (the backtrack peel
    order).  Scores clip at 2^15-2; a 32 kb read's chain can in
    principle exceed that, so ``_reduce_counts`` flags any row whose
    score reaches the clip for exact host recompute."""
    FB = 15
    assert A <= (1 << FB), "packed segmented reduce needs A <= 32768"
    runid = jnp.cumsum(boundary.astype(jnp.int32), axis=1)
    fq = jnp.clip(f, -1, (1 << FB) - 2) + 1  # NEG/invalid -> 0
    pk = (runid << FB) | fq
    seg = jax.lax.cummax(pk, axis=1)
    best_f = (seg & ((1 << FB) - 1)) - 1
    if not want_slot:
        return best_f, None
    SB = 15
    # pk fits int32: runid <= A = 2^15 shifted by 15 -> < 2^31
    assert A <= (1 << SB), "packed (f,slot) reduction needs A <= 32768"
    slots_i = jnp.broadcast_to(jnp.arange(A, dtype=jnp.int32), (B, A))
    # every run's first element is a record (strictly larger runid), so
    # the rec cummax never leaks across runs
    rec = jax.lax.cummax(
        jnp.where(pk == seg, (runid << SB) | slots_i, -1), axis=1
    )
    return best_f, rec & ((1 << SB) - 1)


def _reduce_counts(
    f, broke, rid_s, key2_s, valid_s, n_anchors, B, A, W, min_score,
    cnt=None, min_cnt=3, want_pairs=True, extents=None,
):
    # ---- 4. segmented max over rid runs ----
    boundary = jnp.concatenate(
        [jnp.ones((B, 1), dtype=bool), rid_s[:, 1:] != rid_s[:, :-1]], axis=1
    )
    run_end = jnp.concatenate(
        [rid_s[:, 1:] != rid_s[:, :-1], jnp.ones((B, 1), dtype=bool)], axis=1
    )
    suspicious = None
    if cnt is None:
        seg_f, _ = _seg_best(f, boundary, A, B, want_slot=False)
        passing = run_end & valid_s & (seg_f >= min_score)
    else:
        # HPC presets: a chain must also have >= min_cnt anchors.  The
        # surviving-intact chain of a run is the one ending at the
        # best-f anchor (largest slot among f ties, matching the
        # backtrack peel order), so reduce the packed (f, slot) key and
        # read that anchor's chain count.  Runs whose best chain passes
        # the score but fails min_cnt are flagged: a lower secondary
        # chain might still pass after truncation, which only the exact
        # host path can decide (vanishingly rare: needs a >=100-base
        # span from <3 anchors).
        best_f, best_slot = _seg_best(f, boundary, A, B, want_slot=True)
        cnt_best = jnp.take_along_axis(cnt, best_slot, axis=1)
        score_ok = run_end & valid_s & (best_f >= min_score)
        passing = score_ok & (cnt_best >= min_cnt)
        suspicious = jnp.any(score_ok & (cnt_best < min_cnt), axis=1)
    if extents is not None:
        # ---- -F / is_internal filtering (mapping.rs:59-77) ----
        # decide per rid run from its BEST chain (peeled intact by the
        # backtrack): non-internal best -> target counts; internal best
        # -> count 0, but flag the row when a same-target secondary
        # chain could pass (enough unclaimed anchors in the run) or the
        # best chain holds a valley the backtrack would trim — only the
        # exact host path can decide those.
        assert cnt is None, "-F extents are constant-span only"
        best_f, best_slot = _seg_best(f, boundary, A, B, want_slot=True)
        score_ok = run_end & valid_s & (best_f >= min_score)
        _ta = lambda x: jnp.take_along_axis(x, best_slot, axis=1)
        span = jnp.int32(extents["span"])
        s_best = _ta(extents["starts"])
        rmf_best = _ta(extents["rmf"])
        cnt_best = _ta(extents["cnt"])
        end_r = _ta(extents["rpos"])
        end_q = _ta(extents["qpos"])
        strand_b = _ta(key2_s) & 1
        rs = (s_best >> 16) + 1 - span
        re_ = end_r + 1
        qs_c = (s_best & 0xFFFF) + 1 - span
        qe_c = end_q + 1
        qlen_col = extents["qlen"][:, None]
        rev = strand_b == 1
        qs = jnp.where(rev, qlen_col - qe_c, qs_c)
        qe = jnp.where(rev, qlen_col - qs_c, qe_c)
        T = extents["idx_tlen"].shape[0]
        tlen = extents["idx_tlen"][jnp.clip(rid_s, 0, T - 1)]
        ov_p = jnp.minimum(qs, rs) + jnp.minimum(qlen_col - qe, tlen - re_)
        ov_m = jnp.minimum(qs, tlen - re_) + jnp.minimum(qlen_col - qe, rs)
        ov = jnp.where(rev, ov_m, ov_p)
        maplen = jnp.maximum(jnp.maximum(qe - qs, re_ - rs), 1)
        if extents["mode"] == "internal":
            # forward -F: drop internal matches (mapping.rs:59-77)
            dropped = (
                ov.astype(jnp.float32) / maplen.astype(jnp.float32)
            ) < jnp.float32(extents["ratio"])
        else:
            # inverse --use-min-ref -F: drop overhang-HEAVY matches
            # (`twoset.rs:493-517`; i32 truncation of the f32 product)
            dropped = ov > (
                maplen.astype(jnp.float32) * jnp.float32(extents["ratio"])
            ).astype(jnp.int32)
        passing = score_ok & ~dropped
        # rid-run anchor totals for the secondary-chain bound: run
        # starts broadcast forward with one native cummax (indices are
        # monotone, so no packing is even needed)
        idxs0 = jnp.broadcast_to(jnp.arange(A, dtype=jnp.int32), (B, A))
        rstart = jax.lax.cummax(jnp.where(boundary, idxs0, -1), axis=1)
        run_len = idxs0 - rstart + 1
        sec_possible = (run_len - cnt_best) * span >= min_score
        valley = (rmf_best & 1) == 1
        suspicious = jnp.any(
            score_ok & (valley | (dropped & sec_possible)), axis=1
        )
    counts = jnp.sum(passing, axis=1).astype(jnp.int32)
    if extents is not None:
        # the reference's no_mapping_count counts queries with no
        # mappings AT ALL (pre-filter, `twoset.rs:303-309`); ride that
        # bit above the filtered count (count <= A < 2^24)
        had_any = jnp.any(run_end & valid_s & (best_f >= min_score), axis=1)
        counts = counts | (had_any.astype(jnp.int32) << 24)

    # passing-target id list per query (for symmetric/pair counting):
    # compact passing run-end rids to the front via a stable sort
    if want_pairs:
        PMAX = min(A, PAIR_CAP)
        pk_s, prid = jax.lax.sort(
            (jnp.where(passing, jnp.arange(A, dtype=jnp.int32)[None, :], IMAX), rid_s),
            dimension=1,
            num_keys=1,
            is_stable=True,
        )
        pair_rids = jnp.where(pk_s[:, :PMAX] != IMAX, prid[:, :PMAX], -1)
    else:
        pair_rids = jnp.full((B, 1), -1, jnp.int32)

    # window-miss detector: an anchor's DP is exact when its
    # (rid,strand) run fits in the ring (run depth <= W) OR the
    # max_chain_skip break fired inside the visible window (the scan
    # never looked further).  Rows with any inexact anchor need the
    # exact host path.  Reported as max_run-style int: 0 = exact,
    # window+1 = some anchor missed (keeps the caller contract
    # ``value > window -> fallback``).
    boundary2 = jnp.concatenate(
        [jnp.ones((B, 1), dtype=bool), key2_s[:, 1:] != key2_s[:, :-1]], axis=1
    )
    idxs = jnp.broadcast_to(jnp.arange(A, dtype=jnp.int32), (B, A))
    run_start = jax.lax.cummax(jnp.where(boundary2, idxs, -1), axis=1)
    run_depth = jnp.where(valid_s, idxs - run_start, 0)  # predecessors in run
    missed = valid_s & (run_depth > W) & ~broke
    inexact = jnp.any(missed, axis=1)
    # score-clip guard: _seg_best packs scores in 15 bits, so a chain
    # whose f reaches the clip (possible only for ~32 kb near-perfect
    # chains) could mis-resolve ties — recompute those rows exactly
    inexact = inexact | jnp.any(f >= jnp.int32((1 << 15) - 2), axis=1)
    if suspicious is not None:
        inexact = inexact | suspicious
    max_run = jnp.where(inexact, jnp.int32(W + 1), jnp.int32(0))
    return counts, n_anchors, max_run, pair_rids


@dataclass
class DeviceIndex:
    """Device-resident arrays of a TargetIndex (ONT fast path).

    Alongside the sorted postings, a bucketed unique-hash dictionary
    (``uhash``/``uoff``/``boff``) supports O(KMAX)-gather lookups: the
    top ``bucket_bits`` of the hash index a bucket of distinct hashes,
    within which at most ``bucket_kmax`` linear probes find the match.
    """

    keys: jnp.ndarray
    rid: jnp.ndarray
    pos: jnp.ndarray
    strand: jnp.ndarray
    rank: jnp.ndarray
    mid_occ: int
    uhash: jnp.ndarray = None
    uoff: jnp.ndarray = None
    boff: jnp.ndarray = None
    bucket_bits: int = 0
    bucket_kmax: int = 8

    @classmethod
    def from_host(cls, index, bucket_bits: int = 22) -> "DeviceIndex":
        keys, rid, pos, strand = _pruned_postings(index)
        return cls._build(
            keys, rid, pos, strand, index.name_rank, index.mid_occ,
            index.params.k, bucket_bits,
        )

    @classmethod
    def subindexes(cls, index, n_sub: int, bucket_bits: int = 22) -> list:
        """Split into ``n_sub`` sub-indices by target read (rid modulo).

        Each sub-index is complete for its targets, so per-sub counts
        are disjoint and sum to the full-index counts; this bounds the
        per-query anchor count for very large indices.  All sub-index
        arrays are padded to common shapes so ONE compiled map program
        serves every sub-index.
        """
        keys, rid, pos, strand = _pruned_postings(index)
        subs = []
        for s in range(n_sub):
            sel = rid % n_sub == s
            subs.append(
                cls._build(
                    keys[sel], rid[sel], pos[sel], strand[sel],
                    index.name_rank, index.mid_occ, index.params.k, bucket_bits,
                )
            )
        # pad postings/dictionary arrays to common shapes (sentinel
        # entries are unreachable: bucket offsets only span real uniques)
        npad = max(int(s.keys.shape[0]) for s in subs)
        upad = max(int(s.uhash.shape[0]) for s in subs)
        kmax = max(s.bucket_kmax for s in subs)
        for s in subs:
            s.bucket_kmax = kmax
            n = int(s.keys.shape[0])
            u = int(s.uhash.shape[0])
            if n < npad:
                s.keys = jnp.concatenate(
                    [s.keys, jnp.full(npad - n, IMAX, jnp.int32)]
                )
                s.rid = jnp.concatenate([s.rid, jnp.full(npad - n, IMAX, jnp.int32)])
                s.pos = jnp.concatenate([s.pos, jnp.zeros(npad - n, jnp.int32)])
                s.strand = jnp.concatenate([s.strand, jnp.zeros(npad - n, jnp.int32)])
            if u < upad:
                last = s.uoff[-1]
                s.uhash = jnp.concatenate(
                    [s.uhash, jnp.full(upad - u, IMAX, jnp.int32)]
                )
                s.uoff = jnp.concatenate(
                    [s.uoff, jnp.full(upad - u, last, jnp.int32)]
                )
        return subs

    @classmethod
    def _build(cls, keys_u64, rid, pos, strand, name_rank, mid_occ, k, bucket_bits):
        keys32 = (keys_u64.astype(np.uint32) ^ np.uint32(0x80000000)).view(np.int32)
        hash_bits = 2 * k
        # unique-hash dictionary over the sorted postings: keys32 is
        # monotone in keys_u64 (hash < 2^31), so run boundaries suffice
        if len(keys32):
            ustart = np.flatnonzero(
                np.concatenate(([True], keys32[1:] != keys32[:-1]))
            )
            uh = keys32[ustart]
        else:
            ustart = np.empty(0, dtype=np.int64)
            uh = keys32[:0]
        uoff = np.concatenate([ustart, [len(keys32)]]).astype(np.int32)
        kmax = 8
        if bucket_bits > 0 and hash_bits > bucket_bits and len(uh):
            uh_u = (uh.view(np.uint32) ^ np.uint32(0x80000000)).astype(np.uint64)
            ub = (uh_u >> np.uint64(hash_bits - bucket_bits)).astype(np.int64)
            nb = 1 << bucket_bits
            boff = np.zeros(nb + 1, dtype=np.int32)
            np.add.at(boff, ub + 1, 1)
            np.cumsum(boff, out=boff)
            max_bucket = int(np.max(np.diff(boff))) if len(uh) else 0
            # rounded up to a multiple of 4: the extra probes are
            # masked and a stable
            # kmax keeps the compiled-program cache key corpus-
            # independent (static arg)
            kmax = max(4, (max_bucket + 3) // 4 * 4)
            if kmax > 16:  # pathological collisions: disable dictionary
                bucket_bits = 0
                boff = np.zeros(1, dtype=np.int32)
        else:
            bucket_bits = 0
            boff = np.zeros(1, dtype=np.int32)
        return cls(
            keys=jnp.asarray(keys32),
            rid=jnp.asarray(rid.astype(np.int32)),
            # pack strand into the position's low bit: one fewer [B, A]
            # random gather in the expansion stage
            pos=jnp.asarray((pos.astype(np.int32) << 1) | strand.astype(np.int32)),
            strand=jnp.asarray(strand.astype(np.int32)),
            rank=jnp.asarray(name_rank.astype(np.int32)),
            mid_occ=int(mid_occ),
            uhash=jnp.asarray(uh.astype(np.int32)),
            uoff=jnp.asarray(uoff),
            boff=jnp.asarray(boff),
            bucket_bits=bucket_bits,
            bucket_kmax=kmax,
        )


def _rank_order(index) -> np.ndarray:
    """Target lengths reordered into name-rank space (postings carry
    ranks — see GroupedDeviceIndex.from_host)."""
    rank_of = index.name_rank.astype(np.int64)
    out = np.zeros(len(rank_of), dtype=np.int32)
    out[rank_of] = np.asarray(index.lengths, dtype=np.int32)
    return out


def _pruned_postings(index):
    """Global postings minus minimizers above the occurrence cutoff.

    The mid_occ filter depends only on index-side occurrences, so it is
    applied once at build time (exact; minimap2 applies the same test
    per query seed).  Keys are sorted, so per-key counts come from run
    boundaries (no hashing pass)."""
    keys_all = index.keys
    if len(keys_all):
        starts = np.flatnonzero(np.concatenate(([True], keys_all[1:] != keys_all[:-1])))
        run_counts = np.diff(np.concatenate((starts, [len(keys_all)])))
        keep = np.repeat(run_counts <= index.mid_occ, run_counts)
    else:
        keep = np.ones(0, dtype=bool)
    return keys_all[keep], index.rid[keep], index.pos[keep], index.strand[keep]


def sketch_many_core(codes, lengths, *, k, w):
    """Sketch a super-batch [NB, B, L] in one dispatch."""
    from .sketch_jax import sketch_core

    M = minimizer_cap(codes.shape[-1])

    def real_body(args):
        c, ln = args
        return sketch_core(c, ln, k=k, w=w, max_minimizers=M)

    def empty_body(args):
        c, ln = args
        B = c.shape[0]
        return (
            jnp.full((B, M), 0xFFFFFFFF, jnp.uint32),
            jnp.zeros((B, M), jnp.int32),
            jnp.zeros((B, M), jnp.int32),
            jnp.zeros((B,), jnp.int32),
        )

    def body(args):
        # skip all-padding super-batch slots at runtime (see map_found_many)
        return jax.lax.cond(jnp.any(args[1] > 0), real_body, empty_body, args)

    return jax.lax.map(body, (codes, lengths))


sketch_many = functools.partial(jax.jit, static_argnames=("k", "w"))(sketch_many_core)


def map_many_core(
    mhash,  # [NB, B, M]
    mpos,
    mstrand,
    qlen,  # [NB, B]
    qdualrank,
    qselfrid,
    idx_keys,
    idx_rid,
    idx_pos,
    idx_strand,
    idx_rank,
    mid_occ,
    chn_pen_gap,
    uhash,
    uoff,
    boff,
    *,
    k,
    max_gap,
    bw,
    min_score,
    num_anchors,
    window,
    no_dual,
    no_diag,
    max_chain_skip,
    q_occ_frac,
    bucket_bits,
    bucket_kmax,
    packed_pos,
):
    """Map pre-sketched super-batches against one (sub-)index.

    Splitting sketch from map lets large indices be processed as
    multiple sub-indices (bounded anchor capacity) without re-sketching
    the queries for every sub-index.
    """

    def body(args):
        mh, mp, ms, ql, qd, qs = args
        return map_batch_core(
            idx_keys,
            idx_rid,
            idx_pos,
            idx_strand,
            idx_rank,
            mid_occ,
            mh,
            mp,
            ms,
            ql,
            qd,
            qs,
            chn_pen_gap,
            uhash,
            uoff,
            boff,
            k=k,
            max_gap=max_gap,
            bw=bw,
            min_score=min_score,
            num_anchors=num_anchors,
            window=window,
            no_dual=no_dual,
            no_diag=no_diag,
            max_chain_skip=max_chain_skip,
            q_occ_frac=q_occ_frac,
            bucket_bits=bucket_bits,
            bucket_kmax=bucket_kmax,
            packed_pos=packed_pos,
        )

    return jax.lax.map(body, (mhash, mpos, mstrand, qlen, qdualrank, qselfrid))


map_many = functools.partial(
    jax.jit,
    static_argnames=(
        "k",
        "max_gap",
        "bw",
        "min_score",
        "num_anchors",
        "window",
        "no_dual",
        "no_diag",
        "max_chain_skip",
        "q_occ_frac",
        "bucket_bits",
        "bucket_kmax",
        "packed_pos",
    ),
)(map_many_core)


# ---------------------------------------------------------------------------
# Shared-lookup pipeline: the dictionary lookup and the q_occ filter run
# ONCE per super-batch inside the sketch program; the per-sub-index map
# programs receive precomputed ``found`` planes and only gather their
# own posting ranges.  This removes the per-sub repeat of the lookup's
# gathers.
# ---------------------------------------------------------------------------


_CUCKOO_A1 = 0x9E3779B1  # odd multiply-shift constants (h1 / h2)
_CUCKOO_A2 = 0x85EBCA77


def _cuckoo_slots(mhash, cbits):
    """The two candidate cuckoo slots of a (raw uint32) minimizer hash.

    Multiply-shift with distinct odd constants (h2 premixes with a
    16-bit xorshift so the pair is not affinely related).  Works on
    both numpy and jax arrays — the BUILD (host, numpy) and the LOOKUP
    (device) must agree bit-for-bit."""
    sh = 32 - cbits
    h1 = (mhash * np.uint32(_CUCKOO_A1)) >> np.uint32(sh)
    h2 = ((mhash ^ (mhash >> np.uint32(16))) * np.uint32(_CUCKOO_A2)) >> np.uint32(sh)
    return h1.astype(np.int32), h2.astype(np.int32)


def _build_cuckoo(keys_u32, *, load=0.45, max_rounds=500):
    """Place unique uint32 keys into a 2-choice cuckoo table.

    Parallel random-walk insertion (Alcantara-style): every pending key
    claims its current candidate slot with a random per-round priority;
    losers and evicted previous owners flip to their other candidate.
    Work is proportional to conflicts, so the whole build is a few
    passes over the key set.  Deterministic (fixed seed) so replicated
    multi-process engines build identical tables.

    Sizing: the table is the power of two holding the keys at <=
    ``load`` occupancy (2-choice cuckoo converges reliably below 0.5);
    a non-convergent walk retries once with a doubled table.  Tables
    beyond 2^26 slots are refused — the device carries TWO int32
    planes in cuckoo-slot space (keys + packed offsets), so 2^26 slots
    already cost 512 MB of HBM; larger key sets fall back to the
    bucketed dictionary, whose planes are exactly U-sized.

    Returns ``(pos, cbits)`` — each key's slot and the table's log2
    size — or ``None`` if the walk does not converge (the caller falls
    back to the bucketed dictionary)."""
    U = len(keys_u32)
    if U == 0:
        return None
    cbits = max(10, int(np.ceil(np.log2(max(U, 2) / load))))
    for cb in (cbits, cbits + 1):
        if cb > 26:
            return None
        built = _try_build_cuckoo(keys_u32, cb, max_rounds)
        if built is not None:
            return built
    return None


def _try_build_cuckoo(keys_u32, cbits, max_rounds):
    U = len(keys_u32)
    keys_u32 = keys_u32.astype(np.uint32)
    h1, h2 = _cuckoo_slots(keys_u32, cbits)
    h1 = h1.astype(np.int64)
    h2 = h2.astype(np.int64)
    idx = np.arange(U, dtype=np.int64)
    choice = np.zeros(U, dtype=bool)
    pos = h1.copy()
    owner = np.full(1 << cbits, -1, dtype=np.int64)
    pending = idx
    rng = np.random.default_rng(6)
    for _ in range(max_rounds):
        p_all = pos[pending]
        prev = owner[p_all].copy()
        perm = rng.permutation(len(pending))
        owner[p_all[perm]] = pending[perm]
        now = owner[p_all]
        won = now == pending
        evicted = np.unique(prev[(prev >= 0) & (prev != now)])
        movers = np.concatenate([pending[~won], evicted])
        if movers.size == 0:
            return pos, cbits
        choice[movers] ^= True
        pos[movers] = np.where(choice[movers], h2[movers], h1[movers])
        pending = movers
    return None


def _cuckoo_lookup(mhash, ckey, *, cuckoo_bits):
    """2-probe cuckoo dictionary lookup: TWO [B, M] gathers total
    (the bucketed probe costs ``kmax + 2``; the dictionary stage was
    the single largest device cost at kmax ~8).  ``ckey`` holds the
    transformed keys in cuckoo-slot space; empty slots hold a sentinel
    above the ``2k``-bit hash range, so no real query hash can match
    one."""
    qk = jax.lax.bitcast_convert_type(mhash ^ jnp.uint32(0x80000000), jnp.int32)
    h1, h2 = _cuckoo_slots(mhash, cuckoo_bits)
    k1 = ckey[h1]
    k2 = ckey[h2]
    return jnp.where(k1 == qk, h1, jnp.where(k2 == qk, h2, -1))


def _dict_lookup(mhash, uhash, boff, *, k, bucket_bits, bucket_kmax):
    """Bucketed dictionary probe: unique-hash slot per minimizer (-1 miss).

    TWO windowed gathers total: one [.., 2] slice fetches both bucket
    offsets and one [.., kmax] slice fetches the whole probe window —
    bucket slots are consecutive, and ``bucket_kmax`` bounds every
    bucket, so a window starting at ``min(b0, U-kmax)`` always covers
    ``[b0, b1)``."""
    B, M = mhash.shape
    qk = jax.lax.bitcast_convert_type(mhash ^ jnp.uint32(0x80000000), jnp.int32)
    hash_bits = 2 * k
    nb = 1 << bucket_bits
    ub = jnp.minimum(mhash >> (hash_bits - bucket_bits), jnp.uint32(nb - 1)).astype(
        jnp.int32
    )
    bo = _gatherw(boff, ub, 2)
    b0, b1 = bo[..., 0], bo[..., 1]
    U = uhash.shape[0]
    K = bucket_kmax
    cstart = jnp.clip(b0, 0, max(U - K, 0))
    win = _gatherw(uhash, cstart, K)  # [B, M, K]
    pos = cstart[..., None] + jnp.arange(K, dtype=jnp.int32)
    hit = (pos >= b0[..., None]) & (pos < b1[..., None]) & (win == qk[..., None])
    # unique hashes are distinct: at most one probe slot hits
    return jnp.max(jnp.where(hit, pos, -1), axis=-1)


def sketch_lookup_core(
    codes,  # [B, L] uint8
    lengths,  # [B] int32
    uhash,  # [U] int32 transformed unique hashes (sorted)
    uoff,  # [U+1] int32 global posting offsets
    boff,  # [2^bits+1] int32 bucket offsets
    mid_occ,  # scalar int32
    *,
    k,
    w,
    bucket_bits,
    bucket_kmax,
    q_occ_frac,
    cuckoo_bits=0,
    dict_occ_bits=0,
    want_ranges=False,
):
    """Sketch + index lookup + seed filters in one program.

    Returns ``(found [B,M] int32, mps [B,M] int32, mcount [B] int32)``:
    ``found`` is the unique-hash slot of each minimizer with every seed
    filter already applied (-1 = no anchors: miss, padding, occurrence
    cutoff, or the mm_seed_mz_flt q_occ drop); ``mps`` packs the query
    end position and strand.

    With ``cuckoo_bits`` > 0, ``uhash`` is the cuckoo key plane and
    ``uoff`` the cuckoo-space packed (start << dict_occ_bits) | occ
    plane: the probe is 2 gathers and the occurrence gate 1 (the
    bucketed path costs kmax + 4).

    ``want_ranges`` additionally returns the per-minimizer posting
    range ``(lo, occ)`` the occurrence gate already fetched (occ forced
    to 0 on gated slots), so a same-program consumer (the fused
    single-sub pipeline) need not re-gather the dictionary planes.
    Only valid for single-sub layouts, where the lookup's ranges ARE
    the map's.
    """
    from .sketch_jax import sketch_core

    M = minimizer_cap(codes.shape[1])
    mhash, mpos, mstrand, mcount = sketch_core(
        codes, lengths, k=k, w=w, max_minimizers=M
    )
    B = codes.shape[0]
    if cuckoo_bits:
        found = _cuckoo_lookup(mhash, uhash, cuckoo_bits=cuckoo_bits)
        fc = jnp.maximum(found, 0)
        loocc = uoff[fc]  # empty slots hold occ 0
        occg = jnp.where(
            found >= 0, loocc & ((1 << dict_occ_bits) - 1), 0
        ).astype(jnp.int32)
        lo = loocc >> dict_occ_bits
    else:
        found = _dict_lookup(
            mhash, uhash, boff, k=k, bucket_bits=bucket_bits, bucket_kmax=bucket_kmax
        )
        fc = jnp.maximum(found, 0)
        uo = _gatherw(uoff, fc, 2)  # consecutive offsets: one windowed fetch
        occg = jnp.where(found >= 0, uo[..., 1] - uo[..., 0], 0).astype(jnp.int32)
        lo = uo[..., 0]
    gate = (found >= 0) & (occg > 0) & (occg <= mid_occ)
    gate = gate & (mhash != jnp.uint32(0xFFFFFFFF))

    # mm_seed_mz_flt (q_occ filter), same formulation as map_batch_core
    if q_occ_frac > 0:
        gate = gate & ~_q_occ_drop_narrow(mhash, mid_occ, q_occ_frac)

    found = jnp.where(gate, found, -1)
    mps = mpos * 2 + mstrand
    if want_ranges:
        return found, mps, mcount, lo, jnp.where(gate, occg, 0)
    return found, mps, mcount


def sketch_lookup_many_core(
    codes, lengths, uhash, uoff, boff, mid_occ, *, k, w, bucket_bits, bucket_kmax,
    q_occ_frac, sup_vmap=False, cuckoo_bits=0, dict_occ_bits=0, flatten=False,
):
    def real_body(args):
        c, ln = args
        return sketch_lookup_core(
            c, ln, uhash, uoff, boff, mid_occ,
            k=k, w=w, bucket_bits=bucket_bits, bucket_kmax=bucket_kmax,
            q_occ_frac=q_occ_frac, cuckoo_bits=cuckoo_bits,
            dict_occ_bits=dict_occ_bits,
        )

    if flatten:
        # collapse the super axis into one [NB*B] batch: every stage is
        # data-parallel over rows, so one wide pass amortises the
        # per-slot dispatch/loop overhead of lax.map (see
        # map_found_many_core for the DP argument)
        NB, B, L = codes.shape
        found, mps, mcount = real_body(
            (codes.reshape(NB * B, L), lengths.reshape(NB * B))
        )
        M = found.shape[-1]
        return (
            found.reshape(NB, B, M),
            mps.reshape(NB, B, M),
            mcount.reshape(NB, B),
        )

    if sup_vmap:
        # batch the super axis instead of looping it: every op carries
        # a [SUP*B, ...] shape, so the (latency-bound) sort/scan stages
        # run once instead of SUP times (all-padding slots lose their
        # runtime skip, but only the final group is ever padded)
        return jax.vmap(real_body)((codes, lengths))

    def empty_body(args):
        c, ln = args
        B = c.shape[0]
        M = minimizer_cap(c.shape[1])
        return (
            jnp.full((B, M), -1, jnp.int32),
            jnp.zeros((B, M), jnp.int32),
            jnp.zeros((B,), jnp.int32),
        )

    def body(args):
        # skip all-padding super-batch slots at runtime (see map_found_many)
        return jax.lax.cond(jnp.any(args[1] > 0), real_body, empty_body, args)

    return jax.lax.map(body, (codes, lengths))


sketch_lookup_many = functools.partial(
    jax.jit,
    static_argnames=(
        "k", "w", "bucket_bits", "bucket_kmax", "q_occ_frac", "sup_vmap",
        "cuckoo_bits", "dict_occ_bits", "flatten",
    ),
)(sketch_lookup_many_core)


def map_found_core(
    found,  # [B, M] int32 (-1 = no anchors)
    mps,  # [B, M] int32
    qlen,
    qdualrank,
    qselfrid,
    lo_plane,  # [U] int32: this sub-index's posting range start per unique
    hi_plane,  # [U] int32: .. end
    idx_rid,
    idx_pos,
    idx_strand,
    idx_rank,
    chn_pen_gap,
    *,
    k,
    max_gap,
    bw,
    min_score,
    num_anchors,
    window,
    no_dual,
    no_diag,
    max_chain_skip,
    packed_pos,
    with_spans=False,
    min_cnt=3,
    want_pairs=True,
    packed_rid_bits=0,
    packed_dict_bits=0,
    want_extents=False,
    overhang_ratio=0.2,
    filter_mode="internal",
    idx_tlen=None,
    dp_chunk=1,
    profile_stage="",
    rank_postings=False,
    pre_ranges=None,
):
    if pre_ranges is not None:
        # same-program caller (fused single-sub pipeline) already holds
        # the ranges from the lookup's occurrence gate — skip the
        # dictionary re-gather entirely
        lo, occ = pre_ranges
    else:
        fc = jnp.maximum(found, 0)
        if packed_dict_bits:
            # lo_plane packs (range_start << bits) | occ: ONE [B, M] gather
            lo_occ = lo_plane[fc]
            lo = lo_occ >> packed_dict_bits
            occ = jnp.where(
                found >= 0, lo_occ & ((1 << packed_dict_bits) - 1), 0
            ).astype(jnp.int32)
        else:
            lo = lo_plane[fc]
            hi = hi_plane[fc]
            occ = jnp.where(found >= 0, hi - lo, 0).astype(jnp.int32)
    return _expand_sort_chain(
        lo,
        occ,
        mps,
        qlen,
        qdualrank,
        qselfrid,
        idx_rid,
        idx_pos,
        idx_strand,
        idx_rank,
        chn_pen_gap,
        k=k,
        max_gap=max_gap,
        bw=bw,
        min_score=min_score,
        num_anchors=num_anchors,
        window=window,
        no_dual=no_dual,
        no_diag=no_diag,
        max_chain_skip=max_chain_skip,
        packed_pos=packed_pos,
        with_spans=with_spans,
        min_cnt=min_cnt,
        want_pairs=want_pairs,
        packed_rid_bits=packed_rid_bits,
        want_extents=want_extents,
        overhang_ratio=overhang_ratio,
        filter_mode=filter_mode,
        idx_tlen=idx_tlen,
        dp_chunk=dp_chunk,
        profile_stage=profile_stage,
        rank_postings=rank_postings,
    )


def map_found_many_core(
    found,  # [NB, B, M]
    mps,
    qlen,  # [NB, B]
    qdualrank,
    qselfrid,
    lo_plane,
    hi_plane,
    idx_rid,
    idx_pos,
    idx_strand,
    idx_rank,
    chn_pen_gap,
    *,
    k,
    max_gap,
    bw,
    min_score,
    num_anchors,
    window,
    no_dual,
    no_diag,
    max_chain_skip,
    packed_pos,
    with_spans=False,
    min_cnt=3,
    want_pairs=True,
    packed_rid_bits=0,
    packed_dict_bits=0,
    sup_vmap=False,
    profile_stage="",
    rank_postings=True,
    flatten=False,
    dp_chunk=1,
):
    def real_body(args):
        fo, mp, ql, qd, qs = args
        return map_found_core(
            fo, mp, ql, qd, qs, lo_plane, hi_plane,
            idx_rid, idx_pos, idx_strand, idx_rank, chn_pen_gap,
            k=k, max_gap=max_gap, bw=bw, min_score=min_score,
            num_anchors=num_anchors, window=window, no_dual=no_dual,
            no_diag=no_diag, max_chain_skip=max_chain_skip,
            packed_pos=packed_pos,
            with_spans=with_spans, min_cnt=min_cnt, want_pairs=want_pairs,
            packed_rid_bits=packed_rid_bits, packed_dict_bits=packed_dict_bits,
            profile_stage=profile_stage, rank_postings=rank_postings,
            dp_chunk=dp_chunk,
        )

    def empty_body(args):
        fo, mp, ql, qd, qs = args
        B = ql.shape[0]
        PM = min(num_anchors, PAIR_CAP) if want_pairs else 1
        return (
            jnp.zeros((B,), jnp.int32),
            jnp.zeros((B,), jnp.int32),
            jnp.zeros((B,), jnp.int32),
            jnp.full((B, PM), -1, jnp.int32),
        )

    if flatten:
        # ONE [NB*B]-row core call instead of lax.map over NB slots:
        # the chain DP is a while_loop whose per-iteration cost is
        # latency-bound at [B, W] shapes, so NB sequential loops pay
        # (sum of per-slot anchor bounds) iterations while the
        # flattened loop pays only the GLOBAL max bound — measured
        # ~4x fewer sequential DP steps at bench shapes — and the
        # expand/sort/reduce stages are row-parallel either way
        NB, B, M = found.shape
        _fl = lambda x: x.reshape(NB * B, *x.shape[2:])
        counts, n_anchors, max_run, pairs = real_body(
            (_fl(found), _fl(mps), _fl(qlen), _fl(qdualrank), _fl(qselfrid))
        )
        return (
            counts.reshape(NB, B),
            n_anchors.reshape(NB, B),
            max_run.reshape(NB, B),
            pairs.reshape(NB, B, -1),
        )

    if sup_vmap:
        # batch the super axis: the anchor-slot DP scan and the big
        # sorts run ONCE over [SUP*B, ...] lanes instead of SUP
        # sequential passes (see sketch_lookup_many_core)
        return jax.vmap(real_body)((found, mps, qlen, qdualrank, qselfrid))

    def body(args):
        # super-batch groups are padded to a fixed slot count; all-padding
        # slots skip the whole pipeline at runtime (lax.map lowers to a
        # scan, so this is a true scalar branch, not a vmapped select)
        return jax.lax.cond(jnp.any(args[2] > 0), real_body, empty_body, args)

    return jax.lax.map(body, (found, mps, qlen, qdualrank, qselfrid))


map_found_many = functools.partial(
    jax.jit,
    static_argnames=(
        "k", "max_gap", "bw", "min_score", "num_anchors", "window",
        "no_dual", "no_diag", "max_chain_skip", "packed_pos",
        "with_spans", "min_cnt", "want_pairs",
        "packed_rid_bits", "packed_dict_bits", "sup_vmap", "profile_stage",
        "rank_postings", "flatten", "dp_chunk",
    ),
)(map_found_many_core)


def sketch_map_many_core(
    codes,  # [NB, B, L] uint8
    lengths,  # [NB, B]
    qdualrank,
    qselfrid,
    uhash,
    uoff,
    boff,
    lo_plane,
    hi_plane,
    idx_rid,
    idx_pos,
    idx_rank,
    mid_occ,
    chn_pen_gap,
    *,
    k,
    w,
    bucket_bits,
    bucket_kmax,
    q_occ_frac,
    max_gap,
    bw,
    min_score,
    num_anchors,
    window,
    no_dual,
    no_diag,
    max_chain_skip,
    packed_pos,
    min_cnt=3,
    want_pairs=False,
    packed_rid_bits=0,
    packed_dict_bits=0,
    sort_rows=True,
    want_extents=False,
    overhang_ratio=0.2,
    filter_mode="internal",
    idx_tlen=None,
    dp_chunk=1,
    cuckoo_bits=0,
    flatten=False,
    packed_codes=False,
    profile_stage="",
):
    """Whole ONT pipeline — sketch + lookup + map — in ONE program.

    With ``packed_codes``, ``codes`` arrives 2-bit packed
    ([NB, B, L//4] uint8; see :func:`_unpack2bit`) and is expanded
    on-device — the dominant host->device transfer shrinks 4x.

    The common production case is a single sub-index; splitting sketch
    from map would cost an extra dispatch per super-batch.

    Between the lookup and the chain DP the rows of the WHOLE super
    batch are re-sorted by anchor count: the DP's dynamic trip bound is
    the per-[B]-slot max, and grouping heavy rows together cuts total
    DP iterations ~40% on the bench corpus (length-sorted batching
    alone leaves repeat-heavy rows scattered: 126k vs 75k bound sum at
    NB*B=1024 windows).  Outputs are scattered back to input order and
    packed into one [NB, B, 4] plane (counts, n_anchors, max_run,
    mcount) so the host fetches ONE array (plus pairs when collecting).
    """
    NB, B, L = codes.shape
    if packed_codes:
        L = L * 4
        codes = _unpack2bit(codes, L)

    def sk_body(args):
        c, ln = args
        return sketch_lookup_core(
            c, ln, uhash, uoff, boff, mid_occ,
            k=k, w=w, bucket_bits=bucket_bits, bucket_kmax=bucket_kmax,
            q_occ_frac=q_occ_frac, cuckoo_bits=cuckoo_bits,
            dict_occ_bits=packed_dict_bits,
        )

    if flatten:
        # one [NB*B]-row pass for BOTH halves: the chain DP's
        # while_loop then pays the global max anchor bound once
        # instead of per-slot bounds summed (see map_found_many_core),
        # and the anchor-count row sort below becomes unnecessary —
        # there is only one DP, so per-slot homogeneity buys nothing.
        # The lookup's occurrence gate already fetched each minimizer's
        # posting range, and single-sub layouts share it with the map —
        # thread (lo, occ) through instead of re-gathering.
        fo_f, mps_f, mc_f, lo_f, occ_f = sketch_lookup_core(
            codes.reshape(NB * B, L), lengths.reshape(NB * B),
            uhash, uoff, boff, mid_occ,
            k=k, w=w, bucket_bits=bucket_bits, bucket_kmax=bucket_kmax,
            q_occ_frac=q_occ_frac, cuckoo_bits=cuckoo_bits,
            dict_occ_bits=packed_dict_bits, want_ranges=True,
        )
        counts, n_anchors, max_run, pairs = map_found_core(
            fo_f, mps_f,
            lengths.reshape(NB * B),
            qdualrank.reshape(NB * B),
            qselfrid.reshape(NB * B),
            lo_plane, hi_plane, idx_rid, idx_pos, idx_pos, idx_rank,
            chn_pen_gap,
            k=k, max_gap=max_gap, bw=bw, min_score=min_score,
            num_anchors=num_anchors, window=window, no_dual=no_dual,
            no_diag=no_diag, max_chain_skip=max_chain_skip,
            packed_pos=packed_pos, with_spans=False, min_cnt=min_cnt,
            want_pairs=want_pairs, packed_rid_bits=packed_rid_bits,
            packed_dict_bits=packed_dict_bits, want_extents=want_extents,
            overhang_ratio=overhang_ratio, filter_mode=filter_mode,
            idx_tlen=idx_tlen, dp_chunk=dp_chunk, rank_postings=True,
            pre_ranges=(lo_f, occ_f), profile_stage=profile_stage,
        )
        packed = jnp.stack(
            [counts, n_anchors, max_run, mc_f], axis=-1
        ).reshape(NB, B, 4)
        return packed, pairs.reshape(NB, B, -1)

    found, mps, mcount = jax.lax.map(sk_body, (codes, lengths))
    M = found.shape[-1]
    ff = found.reshape(NB * B, M)
    mf = mps.reshape(NB * B, M)
    # per-row anchor totals (dictionary ranges), then re-sort the super
    # batch so each [B] DP slot holds rows of similar anchor count
    fc = jnp.maximum(ff, 0)
    if packed_dict_bits:
        occ = jnp.where(
            ff >= 0,
            lo_plane[fc] & ((1 << packed_dict_bits) - 1),
            0,
        )
    else:
        occ = jnp.where(
            ff >= 0, hi_plane[fc] - lo_plane[fc], 0
        )
    totals = occ.sum(axis=1)
    if sort_rows:
        order = jnp.argsort(totals)
        inv = jnp.argsort(order)
        ffs = ff[order].reshape(NB, B, M)
        mfs = mf[order].reshape(NB, B, M)
        qlen_s = lengths.reshape(-1)[order].reshape(NB, B)
        qd_s = qdualrank.reshape(-1)[order].reshape(NB, B)
        qs_s = qselfrid.reshape(-1)[order].reshape(NB, B)
    else:
        ffs, mfs = found, mps
        qlen_s, qd_s, qs_s = lengths, qdualrank, qselfrid

    def map_body(args):
        fo, mp, ql, qd, qs = args
        counts, n_anchors, max_run, pairs = map_found_core(
            fo, mp, ql, qd, qs, lo_plane, hi_plane,
            idx_rid, idx_pos, idx_pos, idx_rank, chn_pen_gap,
            k=k, max_gap=max_gap, bw=bw, min_score=min_score,
            num_anchors=num_anchors, window=window, no_dual=no_dual,
            no_diag=no_diag, max_chain_skip=max_chain_skip,
            packed_pos=packed_pos, with_spans=False, min_cnt=min_cnt,
            want_pairs=want_pairs, packed_rid_bits=packed_rid_bits,
            packed_dict_bits=packed_dict_bits, want_extents=want_extents,
            overhang_ratio=overhang_ratio, filter_mode=filter_mode,
            idx_tlen=idx_tlen, dp_chunk=dp_chunk, rank_postings=True,
        )
        return jnp.stack([counts, n_anchors, max_run], axis=-1), pairs

    packed_s, pairs_s = jax.lax.map(
        map_body, (ffs, mfs, qlen_s, qd_s, qs_s)
    )
    if sort_rows:
        packed = packed_s.reshape(NB * B, 3)[inv].reshape(NB, B, 3)
        PM = pairs_s.shape[-1]
        pairs = pairs_s.reshape(NB * B, PM)[inv].reshape(NB, B, PM)
    else:
        packed, pairs = packed_s, pairs_s
    packed = jnp.concatenate([packed, mcount[..., None]], axis=-1)
    return packed, pairs


sketch_map_many = functools.partial(
    jax.jit,
    static_argnames=(
        "k", "w", "bucket_bits", "bucket_kmax", "q_occ_frac",
        "max_gap", "bw", "min_score", "num_anchors", "window",
        "no_dual", "no_diag", "max_chain_skip", "packed_pos",
        "min_cnt", "want_pairs", "packed_rid_bits", "packed_dict_bits",
        "sort_rows", "want_extents", "overhang_ratio", "filter_mode", "dp_chunk",
        "cuckoo_bits", "flatten", "packed_codes", "profile_stage",
    ),
)(sketch_map_many_core)


@dataclass
class GroupedDeviceIndex:
    """Device index with postings grouped by (key, sub) for shared lookup.

    Postings are ordered by (minimizer key, ``rid % n_sub``, rid, pos);
    each sub-index is the complete posting set of its targets, so
    per-sub counts are disjoint and sum to the full-index counts, while
    the unique-hash dictionary (``uhash``/``boff``) is GLOBAL and probed
    once per query batch.  ``lo``/``hi`` [S, U] give each sub's posting
    range per unique hash.
    """

    rid: jnp.ndarray  # [N] int32
    pos: jnp.ndarray  # [N] int32 (pos<<1 | strand)
    rank: jnp.ndarray  # [T] int32
    mid_occ: int
    uhash: jnp.ndarray  # [U] int32 (narrow keys; hi plane when wide)
    uoff: jnp.ndarray  # [U+1] int32
    boff: jnp.ndarray
    lo: list  # n_sub device arrays [U] int32
    hi: list
    bucket_bits: int
    bucket_kmax: int
    n_sub: int
    uhash_lo: jnp.ndarray = None  # wide keys: low 19-bit plane
    wide: bool = False
    # single-gather packings (0 = disabled).  ``rps`` packs
    # rid<<(1+pos_bits) | pos<<1 | strand into ONE posting plane when the
    # bit widths fit (halves the dominant [B, A] posting gathers);
    # ``loocc`` packs each sub's posting-range start and width into one
    # dictionary plane (halves the [B, M] range gathers).
    packed_rid_bits: int = 0  # = pos_bits when active
    rps: jnp.ndarray = None  # [N] int32
    packed_dict_bits: int = 0  # = occ_bits when active
    loocc: list = None  # n_sub device arrays [U] int32
    tlen: jnp.ndarray = None  # [T] int32 target lengths (the -F extent path)
    # 2-probe cuckoo dictionary (narrow single-sub packed layout): when
    # > 0, ``uhash``/``uoff``/``loocc`` live in cuckoo-slot space
    # ([2^cuckoo_bits]; ``uoff`` == ``loocc[0]``) and the bucketed
    # ``boff`` planes are dummies
    cuckoo_bits: int = 0

    @classmethod
    def from_host(cls, index, n_sub: int, bucket_bits: int = 22) -> "GroupedDeviceIndex":
        keys, rid, pos, strand = _pruned_postings(index)
        N = len(keys)
        if N == 0:
            return None
        wide = 2 * index.params.k > 31
        sub = (rid % n_sub).astype(np.int64)
        if wide:
            keys32 = None
            ustart = np.flatnonzero(np.concatenate(([True], keys[1:] != keys[:-1])))
        else:
            keys32 = (keys.astype(np.uint32) ^ np.uint32(0x80000000)).view(np.int32)
            ustart = np.flatnonzero(
                np.concatenate(([True], keys32[1:] != keys32[:-1]))
            )
        U = len(ustart)
        uoff = np.concatenate([ustart, [N]]).astype(np.int32)
        run_u = np.repeat(np.arange(U, dtype=np.int64), np.diff(uoff))
        # group by sub within each key run, preserving (rid, pos) order
        order = np.lexsort((sub, run_u))
        # postings carry the target's NAME RANK, not its rid: the
        # MM_F_NO_DUAL gate compares ranks, so baking the (bijective)
        # rank into the plane deletes the per-anchor [B, A] rank gather.
        # Counts/runs are
        # unaffected (a permutation of ids preserves run partitioning);
        # the engine translates pair outputs back rank->rid, and tlen
        # below is reordered into rank space for the -F extent path.
        rank_of = index.name_rank.astype(np.int32)
        rid_g = rank_of[rid[order]]
        pos_g = ((pos[order].astype(np.int32)) << 1) | strand[order].astype(np.int32)
        sub_g = sub[order]
        # per-(unique, sub) cumulative offsets
        counts = np.zeros((U, n_sub), dtype=np.int32)
        np.add.at(counts, (run_u, sub_g), 1)
        csum = np.concatenate(
            [np.zeros((U, 1), np.int32), np.cumsum(counts, axis=1, dtype=np.int32)],
            axis=1,
        )
        soff = csum + uoff[:-1, None]  # [U, S+1] absolute
        hash_bits = 2 * index.params.k
        if wide:
            uh_u = keys[ustart].astype(np.uint64)
            uh_planes = (
                (uh_u >> np.uint64(_PB_SPLIT)).astype(np.int32),
                (uh_u & np.uint64(_PB_LOMASK)).astype(np.int32),
            )
        else:
            uh = keys32[ustart]
            uh_u = (uh.view(np.uint32) ^ np.uint32(0x80000000)).astype(np.uint64)
            uh_planes = (uh, None)
        # bucketed dictionary over the global uniques
        kmax = 8
        if bucket_bits > 0 and hash_bits > bucket_bits and U:
            ub = (uh_u >> np.uint64(hash_bits - bucket_bits)).astype(np.int64)
            nb = 1 << bucket_bits
            boff = np.zeros(nb + 1, dtype=np.int32)
            np.add.at(boff, ub + 1, 1)
            np.cumsum(boff, out=boff)
            # multiple of 4 for cache-key stability (probes masked)
            kmax = max(4, (int(np.max(np.diff(boff))) + 3) // 4 * 4)
            if kmax > 16:
                bucket_bits = 0
                boff = np.zeros(1, dtype=np.int32)
        else:
            bucket_bits = 0
            boff = np.zeros(1, dtype=np.int32)
        if wide and bucket_bits == 0:
            # the wide lookup has no binary-search fallback
            return None
        import os

        no_pack = os.environ.get("LRGE_NO_PACK") == "1"
        # single-plane posting packing: rid | pos | strand in one int32
        T = len(index.name_rank)
        rid_bits = max(1, int(T - 1).bit_length()) if T else 1
        max_pos = int(pos_g.max() >> 1) if N else 0
        pos_bits = max(1, max_pos.bit_length())
        packed_rid_bits = 0
        rps = None
        if not no_pack and not wide and rid_bits + pos_bits + 1 <= 31:
            packed_rid_bits = pos_bits
            rps = jnp.asarray((rid_g << (1 + pos_bits)) | pos_g)
        # single-plane dictionary packing: range start | occ in one int32
        max_occ_sub = int(counts.max()) if U and n_sub else 0
        occ_bits = max(1, max_occ_sub.bit_length())
        lo_bits = max(1, int(N).bit_length())
        packed_dict_bits = 0
        loocc = None
        loocc_np = None
        if not no_pack and lo_bits + occ_bits <= 31:
            packed_dict_bits = occ_bits
            loocc_np = [
                (soff[:, s].astype(np.int32) << occ_bits)
                | (soff[:, s + 1] - soff[:, s]).astype(np.int32)
                for s in range(n_sub)
            ]
            loocc = [jnp.asarray(a) for a in loocc_np]
        # 2-probe cuckoo dictionary (the bucketed probe costs kmax + 4
        # gathers per minimizer; the dictionary stage dominated device
        # time at kmax ~8).  Narrow single-sub packed layout only; the
        # sentinel needs one spare value above the 2k-bit hash range,
        # and the occurrence gate rides the packed occ field.  Build
        # failure (non-convergent walk) keeps the bucketed planes.
        cuckoo_bits = 0
        if (
            not wide
            and n_sub == 1
            and packed_dict_bits
            and hash_bits <= 30
            and os.environ.get("LRGE_NO_CUCKOO") != "1"
        ):
            built = _build_cuckoo(uh_u.astype(np.uint32))
            if built is not None:
                cpos, cuckoo_bits = built
                C = 1 << cuckoo_bits
                sentinel = np.uint32(1 << hash_bits)
                ckey_raw = np.full(C, sentinel, dtype=np.uint32)
                ckey_raw[cpos] = uh_u.astype(np.uint32)
                uh_planes = (
                    (ckey_raw ^ np.uint32(0x80000000)).view(np.int32),
                    None,
                )
                lc = np.zeros(C, dtype=np.int32)  # empty slots: occ 0
                lc[cpos] = loocc_np[0]
                loocc = [jnp.asarray(lc)]
                uoff = lc  # the lookup's occurrence-gate plane
                bucket_bits = 0
                boff = np.zeros(1, dtype=np.int32)
        # skip uploading planes the compiled programs never read: under
        # the packed layouts rid/pos live inside ``rps`` and lo/hi
        # inside ``loocc`` — the dummies keep the dataclass shape while
        # saving ~100 MB of HBM + transfer on a bench-sized index
        _dummy = jnp.zeros((1,), jnp.int32)
        return cls(
            rid=_dummy if packed_rid_bits else jnp.asarray(rid_g),
            pos=_dummy if packed_rid_bits else jnp.asarray(pos_g),
            rank=jnp.asarray(index.name_rank.astype(np.int32)),
            mid_occ=int(index.mid_occ),
            uhash=jnp.asarray(uh_planes[0]),
            uoff=jnp.asarray(uoff),
            boff=jnp.asarray(boff),
            lo=(
                [_dummy] * n_sub
                if packed_dict_bits
                else [jnp.asarray(soff[:, s].copy()) for s in range(n_sub)]
            ),
            hi=(
                [_dummy] * n_sub
                if packed_dict_bits
                else [jnp.asarray(soff[:, s + 1].copy()) for s in range(n_sub)]
            ),
            bucket_bits=bucket_bits,
            bucket_kmax=kmax,
            n_sub=n_sub,
            uhash_lo=None if uh_planes[1] is None else jnp.asarray(uh_planes[1]),
            wide=wide,
            packed_rid_bits=packed_rid_bits,
            rps=rps,
            packed_dict_bits=packed_dict_bits,
            loocc=loocc,
            tlen=jnp.asarray(_rank_order(index)),
            cuckoo_bits=cuckoo_bits,
        )


# ---------------------------------------------------------------------------
# Wide-key (PacBio/HPC) lookup: 2k = 38-bit hashes split into two int32
# planes (hi = hash >> 19, lo = hash & 0x7FFFF).  The query minimizers
# are sketched on the HOST (the native kernel is exact for HPC spans
# and loop quirks), so the device work is lookup + map only.
# ---------------------------------------------------------------------------

_PB_SPLIT = 19
_PB_LOMASK = (1 << _PB_SPLIT) - 1


def pb_lookup_core(
    qhi,  # [B, M] int32 (-1 padding)
    qlo,  # [B, M] int32
    uh_hi,  # [U] int32
    uh_lo,  # [U] int32
    uoff,  # [U+1] int32
    boff,
    mid_occ,
    *,
    hash_bits,
    bucket_bits,
    bucket_kmax,
    q_occ_frac,
):
    pad = qhi < 0
    found = _pb_probe(
        qhi, qlo, uh_hi, uh_lo, boff,
        hash_bits=hash_bits, bucket_bits=bucket_bits, bucket_kmax=bucket_kmax,
    )
    fc = jnp.maximum(found, 0)
    uo = _gatherw(uoff, fc, 2)  # consecutive offsets: one windowed fetch
    occg = jnp.where(found >= 0, uo[..., 1] - uo[..., 0], 0).astype(jnp.int32)
    gate = (found >= 0) & ~pad & (occg > 0) & (occg <= mid_occ)

    if q_occ_frac > 0:
        gate = gate & ~_q_occ_drop_wide(qhi, qlo, pad, mid_occ, q_occ_frac)

    return jnp.where(gate, found, -1)


def pb_lookup_many_core(
    qhi, qlo, uh_hi, uh_lo, uoff, boff, mid_occ, *, hash_bits, bucket_bits,
    bucket_kmax, q_occ_frac, sup_vmap=False, flatten=False,
):
    def real_body(args):
        hi, lo = args
        return pb_lookup_core(
            hi, lo, uh_hi, uh_lo, uoff, boff, mid_occ,
            hash_bits=hash_bits, bucket_bits=bucket_bits,
            bucket_kmax=bucket_kmax, q_occ_frac=q_occ_frac,
        )

    if flatten:
        # one [NB*B]-row pass (see sketch_lookup_many_core)
        NB, B, M = qhi.shape
        return real_body(
            (qhi.reshape(NB * B, M), qlo.reshape(NB * B, M))
        ).reshape(NB, B, M)

    if sup_vmap:
        # batch the super axis (see sketch_lookup_many_core)
        return jax.vmap(real_body)((qhi, qlo))

    def body(args):
        # skip all-padding super-batch slots at runtime (see map_found_many)
        return jax.lax.cond(
            jnp.any(args[0] >= 0),
            real_body,
            lambda a: jnp.full(a[0].shape, -1, jnp.int32),
            args,
        )

    return jax.lax.map(body, (qhi, qlo))


pb_lookup_many = functools.partial(
    jax.jit,
    static_argnames=(
        "hash_bits", "bucket_bits", "bucket_kmax", "q_occ_frac", "sup_vmap",
        "flatten",
    ),
)(pb_lookup_many_core)
