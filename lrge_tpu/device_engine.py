"""Batched device overlap engine with exact host fallback.

Drives the fused sketch+lookup and map programs
(``ops.overlap_jax.sketch_lookup_many`` / ``map_found_many``) over
length-bucketed query batches.  The whole per-batch pipeline is a
single compiled dispatch: the engine compiles at most
``len(LENGTH_BUCKETS)`` programs and dispatches once per super-batch.

Rows the device cannot guarantee exactly — sketch-loop quirk reads
(Ns / HPC spans), anchor-buffer overflow, minimizer-capacity
truncation, or a (rid,strand) anchor run longer than the DP window —
are recomputed with the exact host engine, so **counts are always
exact**; the device only accelerates.

Both presets run on device.  ONT (2k <= 32) sketches on device in
uint32 lanes; PacBio/HPC sketches on the host (native kernel — exact
for HPC spans and sketch quirks) and ships 38-bit hash planes to the
device for lookup + span-aware chaining with the min_cnt gate.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

import numpy as np

from .engine import OverlapEngine
from .ops.encode import make_batches
from .ops.index import TargetIndex
from .ops.overlap_jax import (
    map_found_many,
    minimizer_cap,
    sketch_lookup_many,
    sketch_many,
)

logger = logging.getLogger("lrge")

# padded read lengths the engine will compile programs for; reads longer
# than the last bucket fall back to the host path.  Each bucket is a
# separate set of compiled programs with anchor capacity scaled by
# bucket length, so typical long-read length distributions (ONT tails
# beyond 4 kb) and ultralong reads up to 32 kb stay on device (the
# reference's toy.bam fixture tops out at 32,437 bp — that read alone
# exceeds the last bucket and takes the exact host path, like any
# >32 kb ultralong tail).  Sparse buckets still route to the host
# (LRGE_DEVICE_MIN_ROWS), so corpora without long reads never pay the
# 32 kb program's compile.
LENGTH_BUCKETS = (2048, 4096, 8192, 16384, 32768)


@dataclass
class BatchCounts:
    counts: np.ndarray  # [n] unique-target overlap counts
    had_mapping: np.ndarray  # [n] bool
    fallback_rows: int  # rows recomputed on host


def resolve_engine(engine: str, n_work_rows: int) -> str:
    """Resolve the ``"auto"`` engine choice at the point where the
    workload size is known.

    ``auto`` picks the device pipeline only when an accelerator
    backend is present AND the work-row count (queries to map, or
    target reads streamed on the inverse path) is large enough to
    amortise device program compiles/loads — a toy-sized run finishes
    on the exact host engine faster than the device programs compile
    or load from the persistent cache.  Threshold via
    LRGE_AUTO_MIN_ROWS (default 1000); counts are exact on either
    engine.
    """
    if engine != "auto":
        return engine
    import os

    import jax

    if jax.default_backend() == "cpu":
        return "host"
    min_rows = int(os.environ.get("LRGE_AUTO_MIN_ROWS", "1000"))
    return "device" if n_work_rows >= min_rows else "host"


def strategy_engine(index: TargetIndex, **kw) -> "DeviceOverlapEngine":
    """Engine for a NON-lockstep strategy path (ava, --use-min-ref,
    -F): under a multi-process launch it must not shard over the global
    mesh (its schedule is not lockstep, so collective programs would
    deadlock or fetch non-addressable arrays) — build over this
    process's devices instead and run replicated (rank 0 prints)."""
    from .parallel.distributed import is_multihost

    return DeviceOverlapEngine(index, local_only=is_multihost(), **kw)


class DeviceOverlapEngine:
    def __init__(
        self,
        index: TargetIndex,
        *,
        batch_size: int = 128,
        num_anchors: int = 4096,
        window: int = 32,
        length_buckets: tuple = LENGTH_BUCKETS,
        super_batch: int = 4,
        local_only: bool = False,
    ):
        """``local_only``: build the (possibly sharded) device index
        over THIS PROCESS'S devices only.  Under a multi-process launch
        the global-mesh programs are collective — every process must
        enter them in lockstep — so strategies whose schedule is not
        lockstep-sharded (ava, --use-min-ref, -F) run replicated on a
        local mesh instead: identical deterministic inputs everywhere,
        rank 0 prints (see docs/SCALING.md)."""
        import os

        # env knobs for tuning program shapes without code changes
        # (also used by the multi-chip dry run to keep virtual-CPU-mesh
        # programs within the collective rendezvous timeout)
        batch_size = int(os.environ.get("LRGE_DEVICE_BATCH", batch_size))
        num_anchors = int(os.environ.get("LRGE_DEVICE_ANCHORS", num_anchors))
        window = int(os.environ.get("LRGE_DEVICE_WINDOW", window))
        super_batch = int(os.environ.get("LRGE_DEVICE_SUPER", super_batch))
        if "LRGE_DEVICE_BUCKET" in os.environ:
            length_buckets = tuple(
                int(t) for t in os.environ["LRGE_DEVICE_BUCKET"].split(",")
            )
        else:
            import jax

            if jax.default_backend() == "cpu":
                # the CPU backend serves tests and the multi-chip dry
                # run; compiling the big-bucket XLA scan there takes
                # minutes for no coverage gain.  Keep the 4096 bucket
                # (not the smallest) so the standard 2-2.5 kb test
                # corpora still exercise the device path.
                length_buckets = (
                    (4096,) if 4096 in length_buckets else length_buckets[:1]
                )
        from .utils.jaxcache import enable_cache

        enable_cache()
        self.index = index
        self.params = index.params
        self.host = OverlapEngine(index)
        self.batch_size = batch_size
        self.num_anchors = num_anchors
        self.window = window
        self.length_buckets = tuple(sorted(length_buckets))
        self.super_batch = super_batch
        from collections import Counter

        self.fallback_triggers = Counter()  # why rows went to the host
        # PacBio/HPC preset: 2k=38-bit keys (two int32 planes on device)
        # and variable spans; queries are sketched on the host (native
        # kernel, exact incl. HPC quirks) and looked up + chained on
        # device.  Requires the native sketcher for throughput.
        from .native import native as _native

        self.pb_mode = self.params.hpc or 2 * self.params.k > 32
        self.device_ok = len(index.keys) > 0 and (
            (not self.pb_mode) or _native is not None
        )
        # batch the super axis with vmap instead of lax.map (the DP
        # scan and sorts are latency-bound at [B, ...] shapes, so one
        # [SUP*B, ...] pass beats SUP sequential passes)
        self.sup_vmap = os.environ.get("LRGE_SUP_VMAP", "0") == "1"
        # flatten the super axis into one [SUP*B]-row program: the DP
        # while_loop pays the global max anchor bound ONCE instead of
        # per-slot bounds summed (measured ~0.3x DP steps at bench
        # shapes); LRGE_NO_FLAT=1 restores the per-slot lax.map
        self.flatten = (
            os.environ.get("LRGE_NO_FLAT") != "1" and not self.sup_vmap
        )
        # DP chunking: unroll C anchors per while_loop iteration.  The
        # loop's per-trip overhead dominates at [R, W] step shapes on
        # the GPU (H100 80GB HBM3 at a 700 W limit, main-phase
        # device-only map of 5,000 queries: C=1 1.80 s, C=4 0.98 s,
        # C=8 0.85 s); CPU keeps C=1 — the test backend pays compile
        # time per unrolled copy for no win.
        if "LRGE_DP_CHUNK" in os.environ:
            self.dp_chunk = int(os.environ["LRGE_DP_CHUNK"])
        else:
            import jax as _jax

            self.dp_chunk = 8 if _jax.default_backend() != "cpu" else 1
        self.sharded = None
        if self.device_ok:
            import os

            import jax

            devs = jax.local_devices() if local_only else jax.devices()
            n_dev = int(os.environ.get("LRGE_SHARDS", "0")) or len(devs)
            n_dev = min(n_dev, len(devs))
            if n_dev > 1:
                # multi-chip: shard the target index across devices
                # (grouped dictionary + packed planes per shard), ride
                # query blocks around the "data" axis, psum disjoint
                # per-shard counts over "index"
                from .parallel.sharded import (
                    ShardedGroupedIndex,
                    make_mesh,
                    sharded_count_fn,
                )

                n_data = int(os.environ.get("LRGE_MESH_DATA", "0"))
                if not n_data:
                    import jax as _jax

                    # multi-host: data axis spans processes so query
                    # I/O shards per host; single-process / local-only
                    # replicated engines: flat index
                    n_data = (
                        _jax.process_count()
                        if _jax.process_count() > 1 and not local_only
                        else 1
                    )
                sgi = ShardedGroupedIndex.from_host(index, n_dev)
                if sgi is not None:
                    self.sharded = sgi
                    self._mesh = make_mesh(n_data, n_dev // n_data, devices=devs)
                    self._idx_tree = sgi.device_put(self._mesh)
                    p = self.params
                    # per-bucket programs: anchor capacity scales with
                    # the length bucket, and num_anchors is a static of
                    # the compiled ring program, so each capacity gets
                    # its own jitted fn (built lazily, cached)
                    self._sharded_kwargs = dict(
                        k=p.k,
                        max_gap=p.max_gap,
                        bw=p.bw,
                        min_score=p.min_chain_score,
                        window=window,
                        no_dual=p.no_dual,
                        no_diag=p.no_diag,
                        max_chain_skip=p.max_chain_skip,
                        q_occ_frac=p.q_occ_frac,
                        min_cnt=p.min_cnt,
                        wide=sgi.wide,
                        bucket_bits=sgi.bucket_bits,
                        bucket_kmax=sgi.bucket_kmax,
                        packed_rid_bits=sgi.packed_rid_bits,
                        packed_dict_bits=sgi.packed_dict_bits,
                        dp_chunk=self.dp_chunk,
                    )
                    self._sharded_fns = {}
                    self._sharded_fn = self._sharded_fn_for(num_anchors)
                    logger.debug(
                        "device engine: sharded over %d devices (%dx%d mesh)",
                        n_dev, n_data, n_dev // n_data,
                    )
                    return
                logger.warning(
                    "sharded index build failed (bucket collisions); "
                    "falling back to single-device grouped path"
                )
            # bound per-query anchors by splitting large indices into
            # sub-indices (counts are disjoint per sub-index and summed);
            # the minimizer lookup is shared across subs (grouped layout)
            n_post = len(index.keys)
            n_uniq = max(1, len(np.unique(index.keys)) if n_post else 1)
            avg_occ = n_post / n_uniq
            # keyed to the base bucket: larger buckets scale their
            # anchor capacity with length, so the ratio is invariant
            exp_anchors = (self.length_buckets[0] / 3.0) * avg_occ
            self.n_sub = max(1, int(np.ceil(exp_anchors / (0.6 * num_anchors))))
            from .ops.overlap_jax import GroupedDeviceIndex

            # wider buckets shrink the linear-probe depth (bucket_kmax)
            # of the dictionary lookup — each probe step is a [B, M]
            # random gather, the lookup program's dominant cost.  Size
            # the table at ~4 buckets per unique key (kmax ~7 on the
            # bench index vs 14 at the old fixed 22 bits), capped so the
            # offsets stay <= 256 MB.
            if "LRGE_BUCKET_BITS" in os.environ:
                bucket_bits = int(os.environ["LRGE_BUCKET_BITS"])
            else:
                bucket_bits = int(np.ceil(np.log2(max(n_uniq, 2)))) + 2
                bucket_bits = min(max(bucket_bits, 12), 26)
            self.gdev = GroupedDeviceIndex.from_host(
                index, self.n_sub, bucket_bits=bucket_bits
            )
            if self.gdev is None:
                # every posting pruned by the occurrence cutoff
                self.device_ok = False
            logger.debug("device engine: %d sub-indexes (shared lookup)", self.n_sub)

    def _self_ranks(self, names) -> np.ndarray:
        """Query self-ids in NAME-RANK space: the device posting planes
        carry name ranks (GroupedDeviceIndex/ShardedGroupedIndex), so
        the no-diag self compare needs the query's rank, not its rid."""
        rank_of = self.index.name_rank
        out = np.empty(len(names), dtype=np.int32)
        for i, nm in enumerate(names):
            r = self.host._name_to_rid.get(nm, -1)
            out[i] = int(rank_of[r]) if r >= 0 else -1
        return out

    def _ranks_to_rids(self, ranks: np.ndarray) -> np.ndarray:
        """Translate device pair outputs (name ranks) back to rids —
        the engine's external pair contract stays rid-based."""
        inv = getattr(self, "_rank_inv_arr", None)
        if inv is None:
            rank_of = np.asarray(self.index.name_rank, dtype=np.int64)
            inv = np.zeros(len(rank_of), dtype=np.int32)
            inv[rank_of] = np.arange(len(rank_of), dtype=np.int32)
            self._rank_inv_arr = inv
        return inv[ranks]

    def _pb_planes(self, row_seqs, M):
        """Host-sketch a batch of PacBio reads into device lookup planes.

        Returns ``(qhi, qlo, mps, mcount)``: two int32 hash planes
        (38-bit hash split at bit 19, -1 padding), the packed
        pos/span/strand plane (``pos<<9 | span<<1 | strand``), and the
        true minimizer counts (rows exceeding ``M`` must fall back)."""
        from .ops.sketch import sketch_seqs_native

        p = self.params
        mzs = sketch_seqs_native(row_seqs, p.k, p.w, p.hpc)
        n = len(row_seqs)
        qhi = np.full((n, M), -1, dtype=np.int32)
        qlo = np.zeros((n, M), dtype=np.int32)
        mps = np.zeros((n, M), dtype=np.int32)
        mcount = np.zeros(n, dtype=np.int32)
        for i, mz in enumerate(mzs):
            h38 = mz.key >> np.uint64(8)
            c = min(len(h38), M)
            mcount[i] = len(h38)
            qhi[i, :c] = (h38 >> np.uint64(19)).astype(np.int32)[:c]
            qlo[i, :c] = (h38 & np.uint64((1 << 19) - 1)).astype(np.int32)[:c]
            span = (mz.key & np.uint64(0xFF)).astype(np.int32)
            mps[i, :c] = (
                (mz.pos.astype(np.int32)[:c] << 9)
                | (span[:c] << 1)
                | mz.strand.astype(np.int32)[:c]
            )
        return qhi, qlo, mps, mcount

    def _host_count(self, name: bytes, seq: bytes) -> tuple[int, int]:
        return self.host.count_overlaps(name, seq)

    def _host_count_many(self, items):
        """Parallel exact host counting.

        Preferred path: the native whole-pipeline ``count_many`` kernel
        (sketch -> lookup -> chain -> reduce entirely in C++, GIL-free,
        threaded over queries).  Without it, threads only pay off with
        the native chain DP, which releases the GIL; under the
        pure-numpy fallback DP the workers would serialize on the GIL,
        so that path runs the loop inline.
        """
        from concurrent.futures import ThreadPoolExecutor

        import os

        from .native import native as _native

        if _native is not None and hasattr(_native, "count_many"):
            return self.host.count_overlaps_many(items)
        if _native is None or len(items) <= 1:
            return [self._host_count(nm, sq) for nm, sq in items]
        with ThreadPoolExecutor(max_workers=min(os.cpu_count() or 2, len(items))) as ex:
            return list(ex.map(lambda t: self._host_count(*t), items))

    def _has_native_pairs(self) -> bool:
        from .native import native as _native

        return _native is not None and hasattr(_native, "count_many")

    def _host_count_pairs(self, items):
        """``(count, had, rids|None)`` triples; rids is None when the
        native pairs kernel is unavailable or a row truncated (callers
        recover those rows with the full map path)."""
        if self._has_native_pairs():
            return self.host.count_overlaps_many(items, want_pairs=True)
        return [(c, h, None) for c, h in self._host_count_many(items)]

    def _host_count_filtered(
        self, items, ratio, mode="internal", want_pairs=False
    ):
        """Exact host -F counting: unique targets with any mapping that
        passes the overhang filter (`twoset.rs:286-301` with the `-F`
        branch; ``mode="overhang"`` applies the inverted
        ``--use-min-ref`` comparison, `twoset.rs:493-517`).
        map_read-based — the native count kernel has no coordinates —
        so threads parallelise the GIL-releasing chain DP.  With
        ``want_pairs`` each row's result carries the passing target-id
        array (count/pair triples like :meth:`_host_count_pairs`).
        """
        from concurrent.futures import ThreadPoolExecutor

        import os as _os

        ratio32 = np.float32(ratio)

        def one(it):
            nm, sq = it
            recs = self.host.map_read(nm, sq)
            uniq = []
            seen = set()
            for m in recs:
                if m.target_name in seen:
                    continue
                if mode == "internal":
                    if m.is_internal(ratio):
                        continue
                else:
                    # inverse --use-min-ref -F comparison
                    # (`twoset.rs:493-517`: i32-truncated f32 product)
                    if m.strand == "+":
                        overhang = min(m.query_start, m.target_start) + min(
                            m.query_len - m.query_end,
                            m.target_len - m.target_end,
                        )
                    else:
                        overhang = min(
                            m.query_start, m.target_len - m.target_end
                        ) + min(m.query_len - m.query_end, m.target_start)
                    maplen = max(
                        m.query_end - m.query_start,
                        m.target_end - m.target_start,
                    )
                    if overhang > int(np.float32(maplen) * ratio32):
                        continue
                seen.add(m.target_name)
                uniq.append(m.target_name)
            if want_pairs:
                rids = np.array(
                    [self.host._name_to_rid[t] for t in uniq], dtype=np.int32
                )
                return len(uniq), int(bool(recs)), rids
            return len(uniq), int(bool(recs))

        if len(items) <= 1:
            return [one(it) for it in items]
        with ThreadPoolExecutor(
            max_workers=min(_os.cpu_count() or 2, 8)
        ) as ex:
            return list(ex.map(one, items))

    def _fused_disabled(self) -> bool:
        """LRGE_NO_FUSED=1 forces the split sketch+lookup / map
        dispatches instead of the single fused program — the bench's
        fused-vs-unfused A/B knob (read per call; env-togglable)."""
        import os as _os

        return _os.environ.get("LRGE_NO_FUSED") == "1"

    def supports_device_filter(self) -> bool:
        """Whether the -F overhang filter can run on device: the fused
        single-sub ONT program with 16-bit-packable coordinates."""
        return (
            self.device_ok
            and not self.pb_mode
            and self.sharded is None
            and getattr(self, "gdev", None) is not None
            and self.gdev.n_sub == 1
            and not self.sup_vmap
            and not self._fused_disabled()
            # chain-start packing is (rpos << 16) | qpos in int32: the
            # HIGH field must stay below 2^15 or the shift overflows
            # (qpos only needs to fit the low 16 bits)
            and int(np.max(self.index.lengths)) < (1 << 15)
            and self.length_buckets[-1] + self.params.k < (1 << 16)
        )

    def anchor_capacity(self, L: int) -> int:
        """Anchor capacity of the programs for padded length ``L``.

        Constant batch width across buckets (full [B, A] rows keep the
        gather/sort stages occupied); capacity scales with the padded
        length (anchors ~0.5*len on the bench corpus, p99 ~1.0*len, so
        A = num_anchors*L/4096 = L at the default), clamped to the
        packed segmented reduce's 2^15 slots."""
        return min(1 << 15, max(512, (self.num_anchors * L) // 4096))

    def _sharded_fn_for(self, num_anchors: int):
        """The jitted ring-counting fn for one anchor capacity (cached —
        capacity scales with the length bucket and is a compile-time
        static of the program)."""
        fn = self._sharded_fns.get(num_anchors)
        if fn is None:
            from .parallel.sharded import sharded_count_fn

            fn = sharded_count_fn(
                self._mesh, num_anchors=num_anchors, **self._sharded_kwargs
            )
            self._sharded_fns[num_anchors] = fn
        return fn

    def triage_flags(self, live, n_anchors, cap, max_run, mcount, mcap,
                     codes, lengths):
        """Vectorised exactness triage shared by :meth:`count_batch` and
        the multi-host scheduler (`parallel/distributed.py`): flag rows
        whose device result cannot be guaranteed exact — anchor-buffer
        overflow, a (rid,strand) run longer than the DP window,
        minimizer-capacity truncation, or ambiguous bases forcing the
        scalar sketch oracle (ONT only; the PacBio planes are
        host-sketched exactly, so ``codes`` may be None there).  Tallies
        ``fallback_triggers`` with the historical precedence and returns
        the boolean "needs host recompute" mask."""
        t_over = (n_anchors > cap) & live
        t_miss = (max_run > self.window) & live & ~t_over
        t_mini = (mcount > mcap) & live & ~t_over & ~t_miss
        prior = t_over | t_miss | t_mini
        if not self.pb_mode:
            # ambiguous bases force the scalar sketch oracle; the
            # padding tail is code 4 too, so subtract it out
            n_amb = (codes >= 4).sum(axis=-1, dtype=np.int64)
            pad_tail = codes.shape[-1] - lengths
            t_quirk = ((n_amb - pad_tail) > 0) & live & ~prior
        else:
            t_quirk = np.zeros_like(prior)
        for key, trig in (
            ("anchor_overflow", t_over),
            ("window_miss", t_miss),
            ("minimizer_overflow", t_mini),
            ("sketch_quirk", t_quirk),
        ):
            c_t = int(trig.sum())
            if c_t:
                self.fallback_triggers[key] += c_t
        return prior | t_quirk

    def _sharded_group(self, q0, q1, mps, lengths, dual, selfr, nb, A=None):
        """Dispatch one super-batch group through the sharded mesh fn,
        returning arrays shaped like a map_many sub-result
        ([SUPER, B] / [SUPER, B, P]).

        ``q0``/``q1`` are the query hash planes ([G, B, M]; uint32
        mhash + dummy for ONT, int32 qhi/qlo for PacBio) and ``mps`` the
        packed pos/strand plane matching the preset.  ``A`` picks the
        bucket-scaled anchor capacity (defaults to the base capacity)."""
        import jax.numpy as jnp

        fn = self._sharded_fn_for(A or self.num_anchors)
        cs, ans, mrs, prs = [], [], [], []
        for g in range(q0.shape[0]):
            c, a, r, pr = fn(
                self._idx_tree,
                q0[g],
                q1[g],
                mps[g],
                jnp.asarray(lengths[g]),
                jnp.asarray(dual[g]),
                jnp.asarray(selfr[g]),
                jnp.int32(self.sharded.mid_occ),
                jnp.float32(self.params.chn_pen_gap()),
            )
            cs.append(c)
            ans.append(a)
            mrs.append(r)
            prs.append(pr)
        # assemble on host: eager stacking of mesh-sharded outputs would
        # launch a cross-device program per op (and aborts on the CPU
        # collectives backend); the caller consumes numpy anyway
        stack = lambda xs: np.stack([np.asarray(x) for x in xs])
        return stack(cs), stack(ans), stack(mrs), stack(prs)

    def _host_share_fraction(self, n_dev_rows: int, pairs_wanted: bool) -> float:
        """Fraction of device-eligible rows handed to the concurrent
        host engine (shortest rows first; counts stay exact either way).

        The split scales with host cores: the native count_many
        kernel's throughput is ~linear in cores while the device rate is
        fixed, so the balanced split is ``share(c) = c*r / (c*r + 1)``
        with ``r`` = per-core-host rate / device-only rate.  Measured on
        an H100 80GB HBM3 at a 700 W limit with its 16-core host, on the
        4.4 Mbp T=10,000/Q=5,000 deployment: 1,650 and 1,443 q/s per
        core against 5,889 and 5,836 q/s device-only, r = 0.28 and 0.25
        in two runs; the default is 0.26.  Capped at 0.9 — beyond that
        the rows handed over are no longer "cheap short reads".
        Override the ratio with LRGE_HOST_RATE_RATIO or the share
        directly with LRGE_HOST_SHARE.
        """
        import os as _os

        from .native import native as _native

        have_native = _native is not None and hasattr(_native, "count_many")
        if "LRGE_HOST_SHARE" in _os.environ:
            share = float(_os.environ["LRGE_HOST_SHARE"])
        elif not have_native:
            share = 0.0
        else:
            c = _os.cpu_count() or 2
            r = float(_os.environ.get("LRGE_HOST_RATE_RATIO", "0.26"))
            share = min(0.9, c * r / (c * r + 1.0))
        if pairs_wanted and not self._has_native_pairs():
            # pair collection (ava) needs per-target ids; without the
            # native pairs kernel, share rows would fall to the slow
            # per-read map_read recovery — a net loss
            share = 0.0
        if share <= 0 or _native is None or n_dev_rows < 4 * self.batch_size:
            return 0.0
        return share

    def plan_rows(
        self,
        seqs,
        rows,
        *,
        pairs_wanted=False,
        filter_active=False,
        warming=False,
    ):
        """Partition ``rows`` into the three dispatch classes.

        Returns ``(host_rows, host_share_rows, {L: bucket_rows})``:
        rows longer than the last bucket or landing in a sparse bucket
        (< LRGE_DEVICE_MIN_ROWS) go to the host; the shortest
        device-eligible rows are handed to the concurrent host engine
        per :meth:`_host_share_fraction`; the rest partition into
        length buckets.  Shared by :meth:`count_batch` and the
        multi-host lockstep scheduler
        (`parallel/distributed.py`) so the two paths cannot diverge.
        """
        import os as _os

        max_bucket = self.length_buckets[-1]
        long_rows = [i for i in rows if len(seqs[i]) > max_bucket]
        dev_rows = [i for i in rows if len(seqs[i]) <= max_bucket]
        min_rows = (
            0 if warming else int(_os.environ.get("LRGE_DEVICE_MIN_ROWS", 32))
        )
        host_share_rows = []
        if not warming and not filter_active:
            # (-F host counting is map_read-based and slow; keep the
            # chip as the primary engine there)
            share = self._host_share_fraction(
                len(dev_rows), pairs_wanted=pairs_wanted
            )
            if share > 0:
                k = int(len(dev_rows) * share)
                if k:
                    by_len = sorted(dev_rows, key=lambda i: len(seqs[i]))
                    host_share_rows = by_len[:k]
                    dev_rows = by_len[k:]
        bucket_rows = {}
        lo = 0
        for L in self.length_buckets:
            rows_b = [i for i in dev_rows if lo < len(seqs[i]) <= L]
            lo = L
            if 0 < len(rows_b) <= min_rows:
                long_rows.extend(rows_b)
            else:
                bucket_rows[L] = rows_b
        return long_rows, host_share_rows, bucket_rows

    def warmup(
        self, lengths=None, filter_ratio=None, filter_mode="internal",
        want_pairs=False,
    ) -> None:
        """Compile the fused programs ahead of the mapping pass.

        With ``lengths`` (the query read lengths about to be mapped)
        only buckets that will actually receive MORE rows than the
        sparse-routing threshold are compiled — sparse buckets run on
        the host at mapping time, so compiling them is pure waste.
        """
        if not self.device_ok:
            return
        import os as _os

        if self._has_native_pairs():
            # pre-build the host bucket dictionary off the hot path (the
            # host-share future and the retry path would otherwise race
            # to build it during the first mapping pass)
            self.host._bucket_dict()
        min_rows = int(_os.environ.get("LRGE_DEVICE_MIN_ROWS", 32))
        if lengths is not None:
            # mirror count_batch's host-share trim: the shortest rows
            # never reach the device, so buckets they would have filled
            # must not be compiled
            max_bucket = self.length_buckets[-1]
            dev_lens = sorted(x for x in lengths if x <= max_bucket)
            share = (
                0.0
                if filter_ratio is not None
                else self._host_share_fraction(
                    len(dev_lens), pairs_wanted=want_pairs
                )
            )
            k = int(len(dev_lens) * share)
            lengths = dev_lens[k:]
        jobs = []
        lo = 0
        for L in self.length_buckets:
            if lengths is None or sum(lo < x <= L for x in lengths) > min_rows:
                jobs.append((lo, L))
            lo = L
        self._warming = True  # bypass the sparse-bucket host routing
        t0 = time.perf_counter()
        try:

            def _one(job):
                lo_, L_ = job
                fake = [b"ACGT" * (max(lo_ + 4, L_ // 2) // 4)] * 2
                self.count_batch(
                    [b"__warm0", b"__warm1"],
                    fake,
                    collect_pairs={} if want_pairs else None,
                    filter_ratio=filter_ratio,
                    filter_mode=filter_mode,
                )

            if len(jobs) > 1:
                # compile buckets CONCURRENTLY: each bucket is a separate
                # program and XLA compiles release the GIL, so wall time
                # approaches the slowest program instead of the sum
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(len(jobs)) as ex:
                    list(ex.map(_one, jobs))
            else:
                for job in jobs:
                    _one(job)
        finally:
            self._warming = False
        logger.debug(
            "warmup: %d bucket programs compiled or loaded in %.2fs",
            len(jobs), time.perf_counter() - t0,
        )

    def count_batch(
        self,
        names: list,
        seqs: list,
        collect_pairs=None,
        filter_ratio=None,
        filter_mode="internal",
    ) -> BatchCounts:
        """Count overlaps per query; optionally collect passing target
        ids per query into ``collect_pairs`` (a dict qid -> rid array),
        used for the ava strategy's symmetric pair counting and the
        ``--use-min-ref`` per-query accumulation.

        ``filter_ratio`` applies the reference's ``-F`` overhang filter
        on device (callers must check :meth:`supports_device_filter`
        first); ``filter_mode`` picks the forward is_internal comparison
        (``"internal"``) or the inverted ``--use-min-ref`` one
        (``"overhang"``).  Host recomputes (exact map_read + filter)
        cover the flagged rows.  ``filter_ratio`` composes with
        ``collect_pairs``: the pair lists then hold only targets whose
        mappings pass the filter (the ava/inverse ``-F`` paths)."""
        import time as _time

        n = len(seqs)
        counts = np.zeros(n, dtype=np.int32)
        had = np.zeros(n, dtype=bool)
        fallback = 0
        # utilization accounting for this pass (bench reporting): valid
        # anchors the device chained vs total [B, A] slots it executed
        self.last_anchors_valid = 0
        self.last_anchor_slots = 0
        phases = {"prep": 0.0, "enqueue": 0.0, "collect": 0.0, "retry": 0.0}
        _t0 = _time.perf_counter()
        if filter_ratio is None:
            # keep the jit cache key canonical when no filter runs
            filter_mode = "internal"
        else:
            assert self.supports_device_filter() or not self.device_ok
        if not self.device_ok:
            if filter_ratio is not None:
                for i, res_h in enumerate(
                    self._host_count_filtered(
                        list(zip(names, seqs)),
                        filter_ratio,
                        mode=filter_mode,
                        want_pairs=collect_pairs is not None,
                    )
                ):
                    counts[i], had[i] = res_h[0], res_h[1]
                    if collect_pairs is not None:
                        collect_pairs[i] = res_h[2]
                return BatchCounts(counts, had, n)
            if collect_pairs is not None:
                for i, (c, h, rids) in enumerate(
                    self._host_count_pairs(list(zip(names, seqs)))
                ):
                    counts[i], had[i] = c, h
                    if rids is not None:
                        collect_pairs[i] = rids
            else:
                for i, (c, h) in enumerate(
                    self._host_count_many(list(zip(names, seqs)))
                ):
                    counts[i], had[i] = c, h
            return BatchCounts(counts, had, n)

        from .utils.jaxcache import enable_cache

        enable_cache()
        import jax.numpy as jnp

        p = self.params
        max_bucket = self.length_buckets[-1]
        import os as _os

        # sparse buckets are cheaper on the host (a bucket dispatch has
        # a fixed device cost), and the heterogeneous split hands the
        # shortest rows to the exact host engine, which runs
        # CONCURRENTLY with device execution (device waits release
        # the GIL) — see plan_rows
        long_rows, host_share_rows, bucket_rows = self.plan_rows(
            seqs,
            range(n),
            pairs_wanted=collect_pairs is not None,
            filter_active=filter_ratio is not None,
            warming=getattr(self, "_warming", False),
        )
        # long-tail + host-share reads go to the host path concurrently
        # with device execution
        from concurrent.futures import ThreadPoolExecutor

        host_rows_all = long_rows + host_share_rows
        if filter_ratio is not None:
            host_fn = lambda items: self._host_count_filtered(
                items,
                filter_ratio,
                mode=filter_mode,
                want_pairs=collect_pairs is not None,
            )
        elif collect_pairs is not None:
            host_fn = self._host_count_pairs
        else:
            host_fn = self._host_count_many
        long_pool = ThreadPoolExecutor(1) if host_rows_all else None
        long_future = (
            long_pool.submit(host_fn, [(names[i], seqs[i]) for i in host_rows_all])
            if host_rows_all
            else None
        )

        qdualrank = np.array(
            [self.host._dual_rank(nm) if p.no_dual else 0 for nm in names], dtype=np.int32
        )
        qselfrid = self._self_ranks(names)
        # partition device rows into length buckets: each bucket gets
        # its own program shapes (L, and anchor capacity scaled with L,
        # so long reads stay on device instead of falling back)
        SUPER = self.super_batch
        retry = []
        # stage 1: enqueue every super-batch (dispatch is async; keeping
        # results as device arrays pipelines host prep behind execution)
        inflight = []
        for L in self.length_buckets:
            rows_b = bucket_rows.get(L)
            if not rows_b:
                continue
            # dispatch depth shrinks with L to keep group work roughly
            # constant
            B = self.batch_size
            A = self.anchor_capacity(L)
            SUP = max(1, (SUPER * 4096) // L)
            batches = make_batches(
                [seqs[i] for i in rows_b],
                ids=rows_b,
                batch_size=B,
                pad_to=L,
                pow2_lengths=False,
                pad_batch=True,
            )
            for batch in batches:
                L0 = batch.codes.shape[1]
                if L != L0:
                    pad = np.full((batch.codes.shape[0], L - L0), 4, dtype=np.uint8)
                    batch.codes = np.concatenate([batch.codes, pad], axis=1)
            for off in range(0, len(batches), SUP):
                group = batches[off : off + SUP]
                nb = len(group)
                codes = np.full((SUP, B, L), 4, dtype=np.uint8)
                lengths = np.zeros((SUP, B), dtype=np.int32)
                ids = np.full((SUP, B), -1, dtype=np.int32)
                for g, batch in enumerate(group):
                    codes[g] = batch.codes
                    lengths[g] = batch.lengths
                    ids[g] = batch.ids
                dual = np.where(ids >= 0, qdualrank[ids], 0).astype(np.int32)
                selfr = np.where(ids >= 0, qselfrid[ids], -1).astype(np.int32)
                if self.sharded is not None:
                    if self.pb_mode:
                        qhi, qlo, mps_h, mc_h = self._pb_planes(
                            [seqs[i] if i >= 0 else b"" for i in ids.ravel()],
                            minimizer_cap(L),
                        )
                        SH = ids.shape
                        M_L = qhi.shape[1]
                        q0 = jnp.asarray(qhi.reshape(*SH, M_L))
                        q1 = jnp.asarray(qlo.reshape(*SH, M_L))
                        mpsd = jnp.asarray(mps_h.reshape(*SH, M_L))
                        mcount_d = mc_h.reshape(SH)
                    else:
                        mhash, mpos, mstrand, mcount_d = sketch_many(
                            jnp.asarray(codes), jnp.asarray(lengths), k=p.k, w=p.w
                        )
                        q0 = mhash
                        q1 = jnp.zeros(mhash.shape[:2] + (1,), jnp.int32)
                        mpsd = mpos * 2 + mstrand
                    subs = [
                        self._sharded_group(
                            q0, q1, mpsd, lengths, dual, selfr, nb, A=A
                        )
                    ]
                    inflight.append((nb, B, A, codes, lengths, ids, mcount_d, subs))
                    continue
                # fused sketch + shared dictionary lookup (one program),
                # then one gather-lean map dispatch per sub-index
                gd = self.gdev
                if (
                    not self.pb_mode
                    and gd.n_sub == 1
                    and not self.sup_vmap
                    and not self._fused_disabled()
                ):

                    # single-sub ONT fast path: the WHOLE pipeline in one
                    # program, one packed output fetch.  Codes upload
                    # 2-bit packed when flattening (4x less host->device
                    # transfer; ambiguous-base rows are recomputed on
                    # host via the sketch-quirk triage either way)
                    from .ops.overlap_jax import pack2bit_host, sketch_map_many

                    pack_up = (
                        self.flatten
                        and _os.environ.get("LRGE_NO_PACKCODES") != "1"
                    )
                    packed, pr = sketch_map_many(
                        jnp.asarray(pack2bit_host(codes) if pack_up else codes),
                        jnp.asarray(lengths),
                        jnp.asarray(dual),
                        jnp.asarray(selfr),
                        gd.uhash,
                        gd.uoff,
                        gd.boff,
                        gd.loocc[0] if gd.packed_dict_bits else gd.lo[0],
                        gd.hi[0],
                        gd.rps if gd.packed_rid_bits else gd.rid,
                        gd.pos,
                        gd.rank,
                        jnp.int32(gd.mid_occ),
                        jnp.float32(p.chn_pen_gap()),
                        k=p.k,
                        w=p.w,
                        bucket_bits=gd.bucket_bits,
                        bucket_kmax=gd.bucket_kmax,
                        q_occ_frac=p.q_occ_frac,
                        max_gap=p.max_gap,
                        bw=p.bw,
                        min_score=p.min_chain_score,
                        num_anchors=A,
                        window=self.window,
                        no_dual=p.no_dual,
                        no_diag=p.no_diag,
                        max_chain_skip=p.max_chain_skip,
                        packed_pos=True,
                        min_cnt=p.min_cnt,
                        want_pairs=collect_pairs is not None,
                        packed_rid_bits=gd.packed_rid_bits,
                        packed_dict_bits=gd.packed_dict_bits,
                        sort_rows=(
                            not self.flatten
                            and _os.environ.get("LRGE_FUSED_SORT", "1") == "1"
                        ),
                        flatten=self.flatten,
                        want_extents=filter_ratio is not None,
                        overhang_ratio=float(filter_ratio or 0.2),
                        filter_mode=filter_mode,
                        idx_tlen=gd.tlen,
                        dp_chunk=self.dp_chunk,
                        cuckoo_bits=gd.cuckoo_bits,
                        packed_codes=pack_up,
                    )
                    inflight.append(
                        (nb, B, A, codes, lengths, ids, None, (packed, pr))
                    )
                    continue
                if self.pb_mode:
                    from .ops.overlap_jax import pb_lookup_many

                    qhi, qlo, mps_h, mc_h = self._pb_planes(
                        [seqs[i] if i >= 0 else b"" for i in ids.ravel()],
                        minimizer_cap(L),
                    )
                    SH = ids.shape
                    M_L = qhi.shape[1]
                    found = pb_lookup_many(
                        jnp.asarray(qhi.reshape(*SH, M_L)),
                        jnp.asarray(qlo.reshape(*SH, M_L)),
                        gd.uhash,
                        gd.uhash_lo,
                        gd.uoff,
                        gd.boff,
                        jnp.int32(gd.mid_occ),
                        hash_bits=2 * p.k,
                        bucket_bits=gd.bucket_bits,
                        bucket_kmax=gd.bucket_kmax,
                        q_occ_frac=p.q_occ_frac,
                        sup_vmap=self.sup_vmap,
                        flatten=self.flatten,
                    )
                    mps = jnp.asarray(mps_h.reshape(*SH, M_L))
                    mcount_d = mc_h.reshape(SH)
                else:
                    found, mps, mcount_d = sketch_lookup_many(
                        jnp.asarray(codes),
                        jnp.asarray(lengths),
                        gd.uhash,
                        gd.uoff,
                        gd.boff,
                        jnp.int32(gd.mid_occ),
                        k=p.k,
                        w=p.w,
                        bucket_bits=gd.bucket_bits,
                        bucket_kmax=gd.bucket_kmax,
                        q_occ_frac=p.q_occ_frac,
                        sup_vmap=self.sup_vmap,
                        cuckoo_bits=gd.cuckoo_bits,
                        dict_occ_bits=gd.packed_dict_bits,
                        flatten=self.flatten,
                    )
                subs = []
                for s in range(gd.n_sub):
                    subs.append(
                        map_found_many(
                            found,
                            mps,
                            jnp.asarray(lengths),
                            jnp.asarray(dual),
                            jnp.asarray(selfr),
                            gd.loocc[s] if gd.packed_dict_bits else gd.lo[s],
                            gd.hi[s],
                            gd.rps if gd.packed_rid_bits else gd.rid,
                            gd.pos,
                            gd.pos,  # unused under packed_pos
                            gd.rank,
                            jnp.float32(p.chn_pen_gap()),
                            k=p.k,
                            max_gap=p.max_gap,
                            bw=p.bw,
                            min_score=p.min_chain_score,
                            num_anchors=A,
                            window=self.window,
                            no_dual=p.no_dual,
                            no_diag=p.no_diag,
                            max_chain_skip=p.max_chain_skip,
                            packed_pos=True,
                            with_spans=self.pb_mode,
                            min_cnt=p.min_cnt,
                            want_pairs=collect_pairs is not None,
                            packed_rid_bits=gd.packed_rid_bits,
                            packed_dict_bits=gd.packed_dict_bits,
                            sup_vmap=self.sup_vmap,
                            flatten=self.flatten,
                            dp_chunk=self.dp_chunk,
                        )
                    )
                inflight.append((nb, B, A, codes, lengths, ids, mcount_d, subs))
        phases["enqueue"] = _time.perf_counter() - _t0
        # stage 2: collect
        _t0 = _time.perf_counter()
        _tb = _t0
        for nb, B, A, codes, lengths, ids, mcount_d, subs in inflight:
            _L = codes.shape[2]
            SUP, _ = lengths.shape
            M = minimizer_cap(codes.shape[2])
            if mcount_d is None:
                # fused single-program path: one packed [SUP, B, 4] fetch
                packed_d, pr_d = subs
                arr = np.asarray(packed_d).astype(np.int64)
                bcounts = arr[..., 0]
                n_anchors = arr[..., 1]
                max_run = arr[..., 2]
                mcount = arr[..., 3]
                pair_lists = (
                    [np.asarray(pr_d)] if collect_pairs is not None else []
                )
            else:
                bcounts = np.zeros((SUP, B), dtype=np.int64)
                n_anchors = np.zeros((SUP, B), dtype=np.int64)
                max_run = np.zeros((SUP, B), dtype=np.int64)
                pair_lists = []
                for c_s, a_s, r_s, p_s in subs:
                    bcounts += np.asarray(c_s)
                    n_anchors = np.maximum(n_anchors, np.asarray(a_s))
                    max_run = np.maximum(max_run, np.asarray(r_s))
                    if collect_pairs is not None:
                        pair_lists.append(np.asarray(p_s))
                mcount = np.asarray(mcount_d)
            if collect_pairs is not None:
                pair_rids = np.concatenate(pair_lists, axis=-1)
            # vectorised exactness triage (a per-row Python loop here
            # costs ~0.1 ms x thousands of rows, rivaling device time)
            live = ids[:nb] >= 0
            self.last_anchors_valid += int(
                np.minimum(n_anchors[:nb], A)[live].sum()
            )
            self.last_anchor_slots += SUP * B * A
            prior = self.triage_flags(
                live, n_anchors[:nb], A, max_run[:nb], mcount[:nb], M,
                codes[:nb], lengths[:nb],
            )
            if collect_pairs is not None:
                # with -F the count plane carries the pre-filter
                # had-mapping bit at 24; compare against the filtered
                # count only
                cnt_plane = (
                    (bcounts[:nb] & 0xFFFFFF)
                    if filter_ratio is not None
                    else bcounts[:nb]
                )
                t_pair = (
                    ((pair_rids[:nb] >= 0).sum(axis=2) < cnt_plane)
                    & live
                    & ~prior
                )
                c_t = int(t_pair.sum())
                if c_t:
                    self.fallback_triggers["pair_truncation"] += c_t
            else:
                t_pair = np.zeros_like(prior)
            needs = prior | t_pair
            retry.extend(ids[:nb][needs].tolist())
            ok = live & ~needs
            ok_ids = ids[:nb][ok]
            if filter_ratio is not None:
                # -F packs the pre-filter "had any mapping" bit at 24
                raw = bcounts[:nb][ok]
                counts[ok_ids] = raw & 0xFFFFFF
                had[ok_ids] = (raw >> 24) > 0
            else:
                counts[ok_ids] = bcounts[:nb][ok]
                had[ok_ids] = bcounts[:nb][ok] > 0
            if collect_pairs is not None:
                ok_pairs = pair_rids[:nb][ok]
                for qid, pr in zip(ok_ids, ok_pairs):
                    # device pair planes carry name ranks; the external
                    # contract is rid-based
                    collect_pairs[qid] = self._ranks_to_rids(pr[pr >= 0])
            _now = _time.perf_counter()
            phases[f"collect_L{_L}"] = phases.get(f"collect_L{_L}", 0.0) + (_now - _tb)
            _tb = _now
        phases["collect"] = _time.perf_counter() - _t0
        _t0 = _time.perf_counter()
        for qid, res_h in zip(
            retry, host_fn([(names[i], seqs[i]) for i in retry])
        ):
            counts[qid], had[qid] = res_h[0], res_h[1]
            if collect_pairs is not None and res_h[2] is not None:
                collect_pairs[qid] = res_h[2]
            fallback += 1
        if long_future is not None:
            share_set = set(host_share_rows)
            for i, res_h in zip(host_rows_all, long_future.result()):
                counts[i], had[i] = res_h[0], res_h[1]
                if collect_pairs is not None and res_h[2] is not None:
                    collect_pairs[i] = res_h[2]
                if i in share_set:
                    # deliberate heterogeneous scheduling, not a fallback
                    self.fallback_triggers["host_share"] += 1
                    continue
                fallback += 1
                self.fallback_triggers[
                    "long_read" if len(seqs[i]) > max_bucket else "sparse_bucket"
                ] += 1
            long_pool.shutdown()
        phases["retry"] = _time.perf_counter() - _t0
        if fallback:
            logger.debug(
                "device path: %d/%d rows fell back to host (%s)",
                fallback,
                n,
                dict(self.fallback_triggers),
            )
        logger.debug("device path phases: %s", {k: round(v, 2) for k, v in phases.items()})
        self.last_phases = phases
        return BatchCounts(counts, had, fallback)
