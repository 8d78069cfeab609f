"""Multi-chip / multi-host scale-out: sharded target index + ring queries.

The reference's only parallelism is shared-memory threads on one host
(SURVEY.md C16).  The device scale-out design instead shards the
*work*, not the memory:

* mesh axes ``("data", "index")`` over a `jax.sharding.Mesh` — in the
  multi-host configuration ``data`` spans hosts and ``index`` spans the
  chips within a host, so the target index is sharded across EVERY
  device (hosts included) and query I/O is sharded per host;
* the **target read set is partitioned by read** (``rid % S`` over the
  ``S = data*index`` device grid) — each device holds a complete
  grouped sub-index (bucketed hash dictionary + packed posting planes,
  the same layout as the single-chip fast path) for *its* targets, so
  chaining for a (query, target) pair is always local to one device;
* **query blocks ride a ring** around the ``data`` axis
  (`jax.lax.ppermute`): each block visits every data row once,
  accumulating counts against that row's index shards, and arrives
  back home after ``n_data`` hops.  Ring traffic is the query
  minimizer planes + accumulators (small), never the index (large);
* per-device unique-target counts are disjoint by construction, so the
  final merge is one ``all_gather`` over the ``index`` axis.

The occurrence cutoff (``mid_occ``) is applied to the *global* index
before sharding, preserving exact parity with the single-chip path.
Both presets shard: ONT (narrow 30-bit keys, device sketch) and
PacBio/HPC (wide 38-bit keys in two planes, host sketch).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.index import TargetIndex
from ..ops.overlap_jax import (
    _PB_LOMASK,
    _PB_SPLIT,
    _dict_lookup,
    _expand_sort_chain,
    _pb_probe,
    _pruned_postings,
    _q_occ_drop_narrow,
    _q_occ_drop_wide,
    PAIR_CAP,
)


def make_mesh(n_data: int, n_index: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = n_data * n_index
    assert len(devices) >= n, f"need {n} devices, have {len(devices)}"
    arr = np.array(devices[:n]).reshape(n_data, n_index)
    return Mesh(arr, ("data", "index"))


@dataclass
class ShardedGroupedIndex:
    """Per-shard grouped index arrays stacked along a leading S axis.

    Shard ``s`` owns target reads ``{i : i % S == s}``; each shard gets
    its own bucketed unique-hash dictionary and (optionally packed)
    posting planes — the same gather-lean layout as the single-chip
    ``GroupedDeviceIndex`` — padded to common shapes so ONE compiled
    program serves every shard.  Padded dictionary slots are
    unreachable (bucket offsets only span real uniques) and padded
    posting slots are never gathered (occ = 0 for missing keys).
    """

    post0: np.ndarray  # [S, Npad] int32: packed rid<<(1+bits)|pos<<1|strand, or rid
    post1: np.ndarray  # [S, Npad] int32: pos<<1|strand (ignored when packed)
    rank: np.ndarray  # [T] int32 global name ranks (replicated)
    mid_occ: int
    n_shards: int
    uhash: np.ndarray  # [S, Upad] int32 (hi plane when wide)
    uhash_lo: np.ndarray  # [S, Upad] int32 (zeros when narrow)
    dict0: np.ndarray  # [S, Upad] int32: packed start<<occ_bits|occ, or range start
    dict1: np.ndarray  # [S, Upad] int32: range end (ignored when packed)
    boff: np.ndarray  # [S, 2^bits+1] int32 bucket offsets
    bucket_bits: int
    bucket_kmax: int
    packed_rid_bits: int  # = pos_bits when posting packing active, else 0
    packed_dict_bits: int  # = occ_bits when dictionary packing active, else 0
    wide: bool

    @classmethod
    def from_host(cls, index: TargetIndex, n_shards: int):
        """Build from a host index; returns None when no device-friendly
        dictionary exists (pathological bucket collisions)."""
        pkeys, prid, ppos, pstrand = _pruned_postings(index)
        N = len(pkeys)
        S = n_shards
        k = index.params.k
        hash_bits = 2 * k
        wide = hash_bits > 31
        shard_of = prid % S if N else np.zeros(0, np.int64)

        # global packing decisions (must be identical across shards so a
        # single compiled program serves them all)
        T = len(index.name_rank)
        rid_bits = max(1, int(T - 1).bit_length()) if T else 1
        max_pos = int(ppos.max()) if N else 0
        pos_bits = max(1, max_pos.bit_length())
        packed_rid_bits = pos_bits if (not wide and rid_bits + pos_bits + 1 <= 31) else 0

        per_shard = []
        max_n = 1
        max_u = 1
        rank_of = index.name_rank.astype(np.int32)
        for s in range(S):
            sel = np.flatnonzero(shard_of == s)
            skeys = pkeys[sel]  # sorted (global order preserved)
            # postings carry name RANKS (see GroupedDeviceIndex) — the
            # shard partition stays keyed on the original rid
            srid = rank_of[prid[sel]]
            spos = (ppos[sel].astype(np.int32) << 1) | pstrand[sel].astype(np.int32)
            if len(skeys):
                ustart = np.flatnonzero(
                    np.concatenate(([True], skeys[1:] != skeys[:-1]))
                )
            else:
                ustart = np.zeros(0, np.int64)
            uoff = np.concatenate([ustart, [len(skeys)]]).astype(np.int32)
            per_shard.append((skeys, srid, spos, ustart, uoff))
            max_n = max(max_n, len(skeys))
            max_u = max(max_u, len(ustart))

        # shared bucket-bits from the largest shard's unique count
        bucket_bits = int(np.ceil(np.log2(max(max_u, 2)))) + 2
        bucket_bits = min(max(bucket_bits, 12), 26, hash_bits - 1)
        nb = 1 << bucket_bits

        # dictionary packing: per-(shard, unique) occurrence and local
        # range starts (posting arrays are per-shard, so starts are
        # shard-local offsets)
        max_occ = 1
        for skeys, srid, spos, ustart, uoff in per_shard:
            if len(ustart):
                max_occ = max(max_occ, int(np.max(np.diff(uoff))))
        occ_bits = max(1, int(max_occ).bit_length())
        lo_bits = max(1, int(max_n).bit_length())
        packed_dict_bits = occ_bits if lo_bits + occ_bits <= 31 else 0

        IMAX = np.iinfo(np.int32).max
        post0 = np.full((S, max_n), IMAX, np.int32)
        post1 = np.zeros((S, max_n), np.int32)
        uhash = np.full((S, max_u), IMAX, np.int32)
        uhash_lo = np.zeros((S, max_u), np.int32)
        dict0 = np.zeros((S, max_u), np.int32)
        dict1 = np.zeros((S, max_u), np.int32)
        boff = np.zeros((S, nb + 1), np.int32)
        kmax = 4
        for s, (skeys, srid, spos, ustart, uoff) in enumerate(per_shard):
            n = len(skeys)
            u = len(ustart)
            if packed_rid_bits:
                post0[s, :n] = (srid << (1 + packed_rid_bits)) | spos
            else:
                post0[s, :n] = srid
                post1[s, :n] = spos
            if u == 0:
                continue
            uh_u = skeys[ustart].astype(np.uint64)
            if wide:
                uhash[s, :u] = (uh_u >> np.uint64(_PB_SPLIT)).astype(np.int32)
                uhash_lo[s, :u] = (uh_u & np.uint64(_PB_LOMASK)).astype(np.int32)
            else:
                uhash[s, :u] = (
                    skeys[ustart].astype(np.uint32) ^ np.uint32(0x80000000)
                ).view(np.int32)
            if packed_dict_bits:
                dict0[s, :u] = (uoff[:-1] << packed_dict_bits) | np.diff(uoff)
            else:
                dict0[s, :u] = uoff[:-1]
                dict1[s, :u] = uoff[1:]
            ub = (uh_u >> np.uint64(hash_bits - bucket_bits)).astype(np.int64)
            bo = np.zeros(nb + 1, np.int32)
            np.add.at(bo, ub + 1, 1)
            np.cumsum(bo, out=bo)
            boff[s] = bo
            kmax = max(kmax, int(np.max(np.diff(bo))))
        if kmax > 24:
            return None  # pathological bucket collisions; caller falls back
        # multiple of 4 for compile-cache-key stability (probes masked)
        kmax = (kmax + 3) // 4 * 4
        # planes the compiled program never reads under the packed
        # layouts shrink to [S, 1] dummies (saves their device_put)
        if packed_rid_bits:
            post1 = np.zeros((S, 1), np.int32)
        if packed_dict_bits:
            dict1 = np.zeros((S, 1), np.int32)
        return cls(
            post0=post0,
            post1=post1,
            rank=index.name_rank.astype(np.int32),
            mid_occ=int(index.mid_occ),
            n_shards=S,
            uhash=uhash,
            uhash_lo=uhash_lo,
            dict0=dict0,
            dict1=dict1,
            boff=boff,
            bucket_bits=bucket_bits,
            bucket_kmax=kmax,
            packed_rid_bits=packed_rid_bits,
            packed_dict_bits=packed_dict_bits,
            wide=wide,
        )

    def device_put(self, mesh: Mesh):
        """Transfer the stacked shard arrays to the mesh ONCE.

        The leading S axis is split over BOTH mesh axes (data-major) —
        in the multi-host mesh each process only materialises its
        addressable shards.  Returns the pytree of global arrays the
        :func:`sharded_count_fn` jit expects as its index operands.
        """
        sh = NamedSharding(mesh, P(("data", "index"), None))
        rep = NamedSharding(mesh, P(None))
        return (
            jax.device_put(self.post0, sh),
            jax.device_put(self.post1, sh),
            jax.device_put(self.rank, rep),
            jax.device_put(self.uhash, sh),
            jax.device_put(self.uhash_lo, sh),
            jax.device_put(self.dict0, sh),
            jax.device_put(self.dict1, sh),
            jax.device_put(self.boff, sh),
        )


def sharded_count_fn(
    mesh: Mesh,
    *,
    k,
    max_gap,
    bw,
    min_score,
    num_anchors,
    window,
    no_dual,
    no_diag,
    max_chain_skip=25,
    q_occ_frac=0.01,
    min_cnt=3,
    wide=False,
    bucket_bits=22,
    bucket_kmax=8,
    packed_rid_bits=0,
    packed_dict_bits=0,
    want_pairs=True,
    no_collectives=False,
    dp_chunk=1,
):
    """Build the jitted ring-counting function over ``mesh``.

    ``no_collectives`` compiles a TIMING-ONLY variant with every
    collective (ring ppermute, psum/pmax merge, pair all_gather)
    removed while the per-device compute is unchanged: comparing its
    wall time against the real program isolates the collective share of
    a dispatch, which is what an N-host scaling-efficiency
    extrapolation needs (BASELINE.md: >=0.8 at 2 hosts).  Its COUNTS
    ARE WRONG (each block only sees its home shards) — never use it
    for results.

    Returns ``fn(idx_tree, q0, q1, mps, qlen, qdualrank, qselfrid,
    mid_occ, chn_pen_gap) -> (counts [B], n_anchors [B], max_run [B],
    pair_rids [B, ...])`` where ``idx_tree`` is
    :meth:`ShardedGroupedIndex.device_put`'s result, ``q0``/``q1`` are
    the query hash planes ([B, M] uint32 ``mhash`` + dummy when narrow;
    int32 ``qhi``/``qlo`` when wide), and ``mps`` is the packed
    query-pos/strand plane (``pos*2|strand`` narrow,
    ``pos<<9|span<<1|strand`` wide).  B is the *global* query batch,
    sharded over "data" and replicated over "index".
    """
    from ..utils.jaxcache import enable_cache

    enable_cache()
    n_data, n_index = mesh.devices.shape
    hash_bits = 2 * k

    def per_device(post0, post1, rank, uhash, uhash_lo, dict0, dict1, boff,
                   q0, q1, mps, qlen, qdual, qself, mid_occ, pen):
        # index operands arrive with a leading local-shard axis of 1
        post0, post1 = post0[0], post1[0]
        uhash, uhash_lo = uhash[0], uhash_lo[0]
        dict0, dict1, boff = dict0[0], dict1[0], boff[0]
        b, M = q0.shape
        mid = mid_occ

        # ---- query-side filters: computed once, ride the ring ----
        if wide:
            pad = q0 < 0
            drop = _q_occ_drop_wide(q0, q1, pad, mid, q_occ_frac) if q_occ_frac > 0 else jnp.zeros_like(pad)
        else:
            pad = q0 == jnp.uint32(0xFFFFFFFF)
            drop = _q_occ_drop_narrow(q0, mid, q_occ_frac) if q_occ_frac > 0 else jnp.zeros_like(pad)
        keep = ~(pad | drop)

        PM = min(num_anchors, PAIR_CAP) if want_pairs else 1
        counts = jnp.zeros((b,), jnp.int32)
        na = jnp.zeros((b,), jnp.int32)
        mr = jnp.zeros((b,), jnp.int32)
        pairs = jnp.full((b, n_data * PM), -1, jnp.int32)
        block = (q0, q1, mps, qlen, qdual, qself, keep)

        # ---- ring over the data axis: the block visits every row ----
        for step in range(n_data):
            c0, c1, cmps, cql, cqd, cqs, ckeep = block
            if wide:
                found = _pb_probe(
                    c0, c1, uhash, uhash_lo, boff,
                    hash_bits=hash_bits, bucket_bits=bucket_bits,
                    bucket_kmax=bucket_kmax,
                )
            else:
                found = _dict_lookup(
                    c0, uhash, boff,
                    k=k, bucket_bits=bucket_bits, bucket_kmax=bucket_kmax,
                )
            fc = jnp.maximum(found, 0)
            if packed_dict_bits:
                lo_occ = dict0[fc]
                lo = lo_occ >> packed_dict_bits
                occ = (lo_occ & ((1 << packed_dict_bits) - 1)).astype(jnp.int32)
            else:
                lo = dict0[fc]
                occ = (dict1[fc] - lo).astype(jnp.int32)
            occ = jnp.where(ckeep & (found >= 0) & (occ <= mid), occ, 0)
            c, a, r, pr = _expand_sort_chain(
                lo, occ, cmps, cql, cqd, cqs,
                post0, post1, post1, rank, pen,
                k=k, max_gap=max_gap, bw=bw, min_score=min_score,
                num_anchors=num_anchors, window=window,
                no_dual=no_dual, no_diag=no_diag,
                max_chain_skip=max_chain_skip,
                packed_pos=True, with_spans=wide, min_cnt=min_cnt,
                want_pairs=want_pairs, packed_rid_bits=packed_rid_bits,
                rank_postings=True, dp_chunk=dp_chunk,
            )
            counts = counts + c
            na = jnp.maximum(na, a)
            mr = jnp.maximum(mr, r)
            if want_pairs:
                pairs = jax.lax.dynamic_update_slice(pairs, pr, (0, step * PM))
            if n_data > 1 and not no_collectives:
                # rotate block + accumulators one row forward; after
                # n_data hops everything is back on its home row.  The
                # ENTIRE riding state travels as ONE ppermute of a
                # concatenated int32 plane — a per-array tree.map
                # issued ~11 collectives per hop, and each collective
                # carries a fixed launch latency (the payload itself is
                # tiny)
                perm = [(i, (i + 1) % n_data) for i in range(n_data)]
                parts = [
                    c0, c1, cmps, cql[:, None], cqd[:, None], cqs[:, None],
                    ckeep, counts[:, None], na[:, None], mr[:, None], pairs,
                ]
                dtypes = [x.dtype for x in parts]
                widths = [x.shape[1] for x in parts]
                as_i32 = [
                    x.astype(jnp.int32)
                    if x.dtype == jnp.bool_
                    else (
                        jax.lax.bitcast_convert_type(x, jnp.int32)
                        if x.dtype != jnp.int32
                        else x
                    )
                    for x in parts
                ]
                state = jax.lax.ppermute(
                    jnp.concatenate(as_i32, axis=1), "data", perm
                )
                out, off = [], 0
                for dt, wd in zip(dtypes, widths):
                    piece = state[:, off : off + wd]
                    off += wd
                    if dt == jnp.bool_:
                        piece = piece != 0
                    elif dt != jnp.int32:
                        piece = jax.lax.bitcast_convert_type(piece, dt)
                    out.append(piece)
                (c0, c1, cmps, cql1, cqd1, cqs1, ckeep,
                 counts1, na1, mr1, pairs) = out
                block = (
                    c0, c1, cmps, cql1[:, 0], cqd1[:, 0], cqs1[:, 0], ckeep,
                )
                counts, na, mr = counts1[:, 0], na1[:, 0], mr1[:, 0]

        if no_collectives:
            # timing-only: same compute, no merge — pad pairs to the
            # real program's output shape
            allp = jnp.concatenate(
                [pairs] * n_index, axis=1
            ) if n_index > 1 else pairs
            return counts, na, mr, allp

        # ---- disjoint target shards: merge over the index axis ----
        # ONE all_gather of the concatenated per-shard results, reduced
        # locally (sum for counts, max for the exactness flags) — the
        # psum + 2 pmax + all_gather it replaces cost 4 collective
        # launches for the same bytes
        merged = jax.lax.all_gather(
            jnp.concatenate(
                [counts[:, None], na[:, None], mr[:, None], pairs], axis=1
            ),
            axis_name="index",
        )  # [S_idx, b, 3 + n_data*PM]
        counts = jnp.sum(merged[:, :, 0], axis=0)
        na = jnp.max(merged[:, :, 1], axis=0)
        mr = jnp.max(merged[:, :, 2], axis=0)
        allp = jnp.transpose(merged[:, :, 3:], (1, 0, 2)).reshape(b, -1)
        return counts, na, mr, allp

    idx_spec = P(("data", "index"), None)
    shard = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(
            idx_spec,  # post0
            idx_spec,  # post1
            P(None),  # rank (replicated)
            idx_spec,  # uhash
            idx_spec,  # uhash_lo
            idx_spec,  # dict0
            idx_spec,  # dict1
            idx_spec,  # boff
            P("data", None),  # q0
            P("data", None),  # q1
            P("data", None),  # mps
            P("data"),  # qlen
            P("data"),  # qdual
            P("data"),  # qself
            P(),  # mid_occ scalar
            P(),  # chn_pen_gap scalar
        ),
        out_specs=(P("data"), P("data"), P("data"), P("data", None)),
        # the scan carry is initialised inside the mapped function; skip
        # the varying-manual-axes check rather than pcast every buffer
        check_vma=False,
    )

    def fn(idx_tree, q0, q1, mps, qlen, qdual, qself, mid_occ, pen):
        return shard(*idx_tree, q0, q1, mps, qlen, qdual, qself, mid_occ, pen)

    return jax.jit(fn)
