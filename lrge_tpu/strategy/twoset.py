"""Two-set estimation strategy.

Reproduces `liblrge/src/twoset.rs`: subsample disjoint target and query
read sets, build an index over the targets, count per-query unique
target overlaps, and convert each count to a genome-size estimate.

Orchestration parity notes (file:line refer to the reference):

* read counting + u32 limit + too-few-reads shrink: `twoset.rs:122-151`
* one-draw-then-split sampling: `twoset.rs:153-155` (target set = the
  *last* ``target_num_reads`` sampled indices, `twoset.rs:632-652`)
* intermediate artifacts ``target.fa``/``query.fa``/``overlaps.paf`` in
  the temp dir: `twoset.rs:157-200,244`
* per-read estimate inline with unique-target counting and optional
  internal-overlap filtering: `twoset.rs:286-317`
* ``--use-min-ref``: index the smaller set by base count and stream the
  other (`twoset.rs:370-584`), including its inverted overhang filter
  (`twoset.rs:493-517` drops overhang-heavy overlaps, the opposite of
  `mapping.rs:59-77` — a reference asymmetry preserved deliberately).
"""

from __future__ import annotations

import logging
import os
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from .. import io as lio
from ..compat.rust_rand import split_into_sets, unique_random_set
from ..engine import OverlapEngine
from ..errors import DuplicateReadIdentifierError, TooFewReadsError, TooManyReadsError
from ..estimate import Estimate, per_read_estimate
from ..ops.index import build_index
from ..platform import Platform, preset_for

logger = logging.getLogger("lrge")
TRACE = 5  # below DEBUG, like the reference's TRACE level
logging.addLevelName(TRACE, "TRACE")

DEFAULT_TARGET_NUM_READS = 10_000
DEFAULT_QUERY_NUM_READS = 5_000

U32_MAX = 0xFFFFFFFF


class TwoSetStrategy(Estimate):
    def __init__(
        self,
        input_path: os.PathLike | str,
        *,
        target_num_reads: int = DEFAULT_TARGET_NUM_READS,
        query_num_reads: int = DEFAULT_QUERY_NUM_READS,
        remove_internal: bool = False,
        max_overhang_ratio: float = 0.2,
        use_min_ref: bool = False,
        tmpdir: Optional[os.PathLike | str] = None,
        threads: int = 1,
        seed: Optional[int] = None,
        platform: Platform = Platform.NANOPORE,
        engine: str = "host",
        device_paf: bool = False,
    ):
        self.input = Path(input_path)
        self.engine = engine
        self.device_paf = device_paf
        self.target_num_reads = target_num_reads
        self.query_num_reads = query_num_reads
        self.target_num_bases = 0
        self.query_num_bases = 0
        self.remove_internal = remove_internal
        self.max_overhang_ratio = max_overhang_ratio
        self.use_min_ref = use_min_ref
        self.tmpdir = Path(tmpdir) if tmpdir is not None else Path(tempfile.gettempdir())
        self.threads = threads
        self.seed = seed
        self.platform = platform

    # -- subsampling ---------------------------------------------------

    def split_fastq(self):
        """Select target/query reads in a single streaming pass.

        Returns ``(targets, queries, avg_target_len)`` where each element
        is a list of ``(name, seq)``; also writes ``target.fa`` and
        ``query.fa`` to the temp dir like the reference.
        """
        logger.debug("Counting records in input file...")
        n_reads = lio.count_records(self.input)
        logger.debug("Found %d reads in input file", n_reads)
        if n_reads > U32_MAX:
            raise TooManyReadsError(
                f"Number of reads in input file ({n_reads}) exceeds maximum "
                f"allowed value ({U32_MAX})"
            )
        n_req = self.target_num_reads + self.query_num_reads
        if n_reads <= self.query_num_reads:
            raise TooFewReadsError(
                f"Number of reads in input file ({n_reads}) is <= query "
                f"number of reads ({self.query_num_reads})"
            )
        elif n_reads < n_req:
            logger.warning(
                "Number of reads in input file (%d) is less than the sum of "
                "target and query reads (%d)",
                n_reads,
                n_req,
            )
            self.target_num_reads = n_reads - self.query_num_reads
            n_req = n_reads
            logger.warning("Using %d target reads", self.target_num_reads)

        indices = unique_random_set(n_req, n_reads, self.seed)
        target_idx, query_idx = split_into_sets(indices, self.target_num_reads)

        targets: list[tuple[bytes, bytes]] = []
        queries: list[tuple[bytes, bytes]] = []
        sum_target = 0
        sum_query = 0
        target_path = self.tmpdir / "target.fa"
        query_path = self.tmpdir / "query.fa"
        self.tmpdir.mkdir(parents=True, exist_ok=True)
        with open(target_path, "wb") as tf, open(query_path, "wb") as qf:
            for idx, (name, seq) in enumerate(lio.iter_records(self.input)):
                if idx in target_idx:
                    target_idx.discard(idx)
                    tf.write(b">" + name + b"\n" + seq + b"\n")
                    targets.append((name, seq))
                    sum_target += len(seq)
                elif idx in query_idx:
                    query_idx.discard(idx)
                    qf.write(b">" + name + b"\n" + seq + b"\n")
                    queries.append((name, seq))
                    sum_query += len(seq)
        self.target_num_bases = sum_target
        self.query_num_bases = sum_query
        avg_target_len = np.float32(sum_target) / np.float32(self.target_num_reads)
        logger.debug("Total target bases: %d", sum_target)
        logger.debug("Total query bases: %d", sum_query)
        return targets, queries, float(avg_target_len)

    # -- alignment + estimation ---------------------------------------

    def _build_engine(self, reads):
        params = preset_for(self.platform, dual=True)
        names = [n for n, _ in reads]
        if len(set(names)) != len(names):
            seen = set()
            for n in names:
                if n in seen:
                    raise DuplicateReadIdentifierError(n.decode("utf-8", "replace"))
                seen.add(n)
        index = build_index([s for _, s in reads], names, params)
        return OverlapEngine(index)

    def generate_estimates(self):
        targets, queries, avg_target_len = self.split_fastq()
        if self.use_min_ref and self.target_num_bases > self.query_num_bases:
            return self._align_reads_inverse(targets, queries, avg_target_len)
        return self._align_reads(targets, queries, avg_target_len)

    def _write_paf_host(self, index, rows):
        """Exact ``overlaps.paf`` side-output for device paths.

        The reference writes the PAF unconditionally (`twoset.rs:244`)
        but the device pipeline only produces counts; when the caller
        keeps the temp dir (``-C``/``-D``) the mapped rows are re-run
        through the host ``map_read`` (threaded) so the artifact matches
        the host engine's byte for byte.  ``rows`` must be in query
        order (unmapped rows contribute no lines either way).
        """
        from ..engine import ParallelHostMapper

        mapper = ParallelHostMapper(index, self.threads)
        paf_path = self.tmpdir / "overlaps.paf"
        with open(paf_path, "w") as paf:
            for recs in mapper.map_reads(rows):
                for m in recs:
                    paf.write(m.to_line() + "\n")
        mapper.close()
        logger.debug("Wrote %s from the host mapper (device run)", paf_path)

    def _device_paf_note(self) -> str:
        return (
            "overlaps.paf via host re-map of mapped rows"
            if self.device_paf
            else "overlaps.paf not written; pass -C/-D to produce it"
        )

    def _align_reads(self, targets, queries, avg_target_len):
        """Default direction: index targets, stream queries
        (`twoset.rs:204-367`).

        Queries are mapped on a forked worker pool when ``threads > 1``
        (the reference's rayon pool analogue, `twoset.rs:252-270`).
        With ``engine="device"`` the accelerator counting pipeline is used and
        the PAF side-output is skipped (counts and estimates are exact;
        use the default host engine when overlaps.paf is needed).
        """
        engine = self._build_engine(targets)
        from ..device_engine import resolve_engine

        eng = resolve_engine(self.engine, len(queries))
        if eng == "device" and not self.remove_internal:
            return self._align_reads_device(engine, queries, avg_target_len)
        if eng == "device" and self.remove_internal:
            # -F on device: the fused pipeline tracks chain extents and
            # applies is_internal in the reduce (undecidable rows fall
            # back to the exact host filter); unsupported configurations
            # (HPC preset, multi-chip, wide coordinates) use the host
            from ..device_engine import strategy_engine

            dev = strategy_engine(engine.index)
            if dev.supports_device_filter():
                return self._align_reads_device_filtered(
                    dev, queries, avg_target_len
                )
            logger.info(
                "-F/--filter-contained: this configuration needs mapping "
                "coordinates on the host; using the host engine"
            )
        from ..engine import ParallelHostMapper

        mapper = ParallelHostMapper(engine.index, self.threads)
        overlap_threshold = engine.params.min_chain_score
        estimates = np.empty(len(queries), dtype=np.float32)
        no_mapping_count = 0
        paf_path = self.tmpdir / "overlaps.paf"
        with open(paf_path, "w") as paf:
            for qi, ((qname, seq), mappings) in enumerate(
                zip(queries, mapper.map_reads(queries))
            ):
                unique = set()
                if mappings:
                    for m in mappings:
                        paf.write(m.to_line() + "\n")
                        if self.remove_internal and m.is_internal(self.max_overhang_ratio):
                            continue
                        unique.add(m.target_name)
                else:
                    logger.debug("No overlaps found for read: %s", qname)
                    no_mapping_count += 1
                est = per_read_estimate(
                    len(seq),
                    avg_target_len,
                    self.target_num_reads,
                    len(unique),
                    overlap_threshold,
                )
                logger.log(TRACE, "Estimate for %s: %s", qname.decode("utf-8", "replace"), est)
                estimates[qi] = est
        mapper.close()
        self._log_no_mapping(no_mapping_count, len(queries))
        return estimates, no_mapping_count

    def _align_reads_device(self, engine, queries, avg_target_len):
        """Device counting path (PAF side-output only under -C/-D)."""
        # the forward two-set path IS lockstep-sharded under a
        # multi-process launch, so it builds over the GLOBAL mesh (the
        # other strategies use strategy_engine's local replication)
        from ..device_engine import DeviceOverlapEngine
        from ..estimate import per_read_estimate_batch

        logger.info("Using device overlap engine (%s)", self._device_paf_note())
        dev = DeviceOverlapEngine(engine.index)
        names = [n for n, _ in queries]
        seqs = [s for _, s in queries]
        from ..parallel.distributed import is_multihost

        if is_multihost() and dev.sharded is not None:
            # lockstep multi-process counting: query I/O sharded per
            # host, index sharded across every chip; all processes get
            # the same global counts back (docs/SCALING.md)
            from ..parallel.distributed import multihost_count_batch

            res = multihost_count_batch(dev, names, seqs)
        else:
            dev.warmup([len(s) for s in seqs])
            res = dev.count_batch(names, seqs)
        if self.device_paf:
            self._write_paf_host(
                engine.index,
                [q for q, h in zip(queries, res.had_mapping) if h],
            )
        no_mapping_count = int((~res.had_mapping).sum())
        estimates = per_read_estimate_batch(
            np.array([len(s) for s in seqs]),
            avg_target_len,
            self.target_num_reads,
            res.counts,
            engine.params.min_chain_score,
        )
        if logger.isEnabledFor(TRACE):
            for (qname, _), est in zip(queries, estimates):
                logger.log(
                    TRACE, "Estimate for %s: %s", qname.decode("utf-8", "replace"), est
                )
        self._log_no_mapping(no_mapping_count, len(queries))
        return estimates.astype(np.float32), no_mapping_count

    def _align_reads_device_filtered(self, dev, queries, avg_target_len):
        """Device counting with the -F is_internal filter applied in the
        fused reduce (PAF side-output only under -C/-D)."""
        from ..estimate import per_read_estimate_batch

        logger.info(
            "Using device overlap engine with -F filtering (%s)",
            self._device_paf_note(),
        )
        names = [n for n, _ in queries]
        seqs = [s for _, s in queries]
        dev.warmup([len(s) for s in seqs], filter_ratio=self.max_overhang_ratio)
        res = dev.count_batch(names, seqs, filter_ratio=self.max_overhang_ratio)
        if self.device_paf:
            self._write_paf_host(
                dev.index,
                [q for q, h in zip(queries, res.had_mapping) if h],
            )
        no_mapping_count = int((~res.had_mapping).sum())
        estimates = per_read_estimate_batch(
            np.array([len(s) for s in seqs]),
            avg_target_len,
            self.target_num_reads,
            res.counts,
            dev.params.min_chain_score,
        )
        if logger.isEnabledFor(TRACE):
            for (qname, _), est in zip(queries, estimates):
                logger.log(
                    TRACE, "Estimate for %s: %s", qname.decode("utf-8", "replace"), est
                )
        self._log_no_mapping(no_mapping_count, len(queries))
        return estimates.astype(np.float32), no_mapping_count

    def _align_reads_inverse(self, targets, queries, avg_target_len):
        """--use-min-ref direction: index queries, stream targets
        (`twoset.rs:370-584`).

        With ``engine="device"`` (and no ``-F``) the device pipeline
        maps the target reads against the query index and collects the
        passing query ids per target row (the same pair machinery the
        ava strategy uses); per-query counts are the per-row-deduped
        accumulation, exactly the reference's per-mapping
        ``unique``-set logic."""
        engine = self._build_engine(queries)
        overlap_threshold = engine.params.min_chain_score
        read_lengths = {}
        ovlap_counter = {}
        for qname, seq in queries:
            if qname in read_lengths:
                raise DuplicateReadIdentifierError(qname.decode("utf-8", "replace"))
            read_lengths[qname] = len(seq)
            ovlap_counter[qname] = 0
        from ..device_engine import resolve_engine

        # inverse direction streams TARGET reads against the query
        # index: the work-row count is len(targets)
        if resolve_engine(self.engine, len(targets)) == "device":
            if not self.remove_internal:
                return self._align_reads_inverse_device(
                    engine, targets, queries, avg_target_len, read_lengths,
                    ovlap_counter,
                )
            # inverse -F: the fused extent reduce applies the inverted
            # overhang comparison (`twoset.rs:493-517`) per passing
            # target; undecidable rows recompute on the host
            from ..device_engine import strategy_engine

            dev = strategy_engine(engine.index)
            if dev.supports_device_filter():
                return self._align_reads_inverse_device(
                    engine, targets, queries, avg_target_len, read_lengths,
                    ovlap_counter, dev=dev,
                    filter_ratio=self.max_overhang_ratio,
                )
            logger.info(
                "-F/--filter-contained: this configuration needs mapping "
                "coordinates on the host; using the host engine"
            )
        from ..engine import ParallelHostMapper

        mapper = ParallelHostMapper(engine.index, self.threads)
        paf_path = self.tmpdir / "overlaps.paf"
        with open(paf_path, "w") as paf:
            for (tname, seq), mappings in zip(targets, mapper.map_reads(targets)):
                unique = set()
                for m in mappings:
                    paf.write(m.to_line() + "\n")
                    if m.target_name in unique:
                        continue
                    if self.remove_internal:
                        # NOTE reference asymmetry (`twoset.rs:493-517`):
                        # this path drops overhang-HEAVY overlaps
                        # (overhang > maplen*ratio), the opposite of
                        # is_internal.
                        if m.strand == "+":
                            overhang = min(m.query_start, m.target_start) + min(
                                m.query_len - m.query_end, m.target_len - m.target_end
                            )
                        else:
                            overhang = min(
                                m.query_start, m.target_len - m.target_end
                            ) + min(m.query_len - m.query_end, m.target_start)
                        maplen = max(
                            m.query_end - m.query_start, m.target_end - m.target_start
                        )
                        if overhang > int(np.float32(maplen) * np.float32(self.max_overhang_ratio)):
                            continue
                    ovlap_counter[m.target_name] += 1
                    unique.add(m.target_name)
        mapper.close()
        no_mapping_count = 0
        estimates = np.empty(len(ovlap_counter), dtype=np.float32)
        for i, (rid_name, n_ovlaps) in enumerate(ovlap_counter.items()):
            if n_ovlaps == 0:
                no_mapping_count += 1
                est = float("inf")
            else:
                est = per_read_estimate(
                    read_lengths[rid_name],
                    avg_target_len,
                    self.target_num_reads,
                    n_ovlaps,
                    overlap_threshold,
                )
            logger.log(TRACE, "Estimate for %s: %s", rid_name.decode("utf-8", "replace"), est)
            estimates[i] = est
        self._log_no_mapping(no_mapping_count, len(queries))
        return estimates, no_mapping_count

    def _align_reads_inverse_device(
        self, engine, targets, queries, avg_target_len, read_lengths,
        ovlap_counter, dev=None, filter_ratio=None,
    ):
        """Device --use-min-ref: map targets against the query index,
        accumulate per-query counts from the per-row passing-id lists
        (row-level dedup == the reference's per-target unique set,
        `twoset.rs:481-523`).  With ``filter_ratio`` the pair lists hold
        only targets passing the inverted overhang comparison
        (`twoset.rs:493-517`).  PAF side-output only under -C/-D."""
        from ..device_engine import strategy_engine

        logger.info(
            "Using device overlap engine for --use-min-ref (%s)",
            self._device_paf_note(),
        )
        if dev is None:
            dev = strategy_engine(engine.index)
        tnames = [n for n, _ in targets]
        tseqs = [s for _, s in targets]
        dev.warmup(
            [len(s) for s in tseqs],
            filter_ratio=filter_ratio,
            filter_mode="overhang",
            want_pairs=True,
        )
        collect: dict = {}
        res = dev.count_batch(
            tnames,
            tseqs,
            collect_pairs=collect,
            filter_ratio=filter_ratio,
            filter_mode="overhang",
        )
        if self.device_paf:
            self._write_paf_host(
                engine.index,
                [t for t, h in zip(targets, res.had_mapping) if h],
            )
        counts = np.zeros(len(queries), dtype=np.int64)
        for rids in collect.values():
            counts[rids] += 1
        no_mapping_count = 0
        estimates = np.empty(len(queries), dtype=np.float32)
        for i, (qname, _) in enumerate(queries):
            n_ovlaps = int(counts[i])
            if n_ovlaps == 0:
                no_mapping_count += 1
                est = float("inf")
            else:
                est = per_read_estimate(
                    read_lengths[qname],
                    avg_target_len,
                    self.target_num_reads,
                    n_ovlaps,
                    engine.params.min_chain_score,
                )
            logger.log(
                TRACE, "Estimate for %s: %s", qname.decode("utf-8", "replace"), est
            )
            estimates[i] = est
        self._log_no_mapping(no_mapping_count, len(queries))
        return estimates, no_mapping_count

    def _log_no_mapping(self, count, total):
        if count > 0:
            pct = count / total * 100.0
            logger.info(
                "%d (%.2f%%) query read(s) did not overlap any target reads", count, pct
            )
        else:
            logger.debug("All query reads overlapped with target reads")


class TwoSetBuilder:
    """Builder mirroring `liblrge/src/twoset/builder.rs`."""

    def __init__(self):
        self._kw = {}

    def target_num_reads(self, n: int) -> "TwoSetBuilder":
        self._kw["target_num_reads"] = n
        return self

    def query_num_reads(self, n: int) -> "TwoSetBuilder":
        self._kw["query_num_reads"] = n
        return self

    def remove_internal(self, yes: bool, max_overhang_ratio: float = 0.2) -> "TwoSetBuilder":
        self._kw["remove_internal"] = yes
        self._kw["max_overhang_ratio"] = max_overhang_ratio
        return self

    def use_min_ref(self, yes: bool) -> "TwoSetBuilder":
        self._kw["use_min_ref"] = yes
        return self

    def threads(self, n: int) -> "TwoSetBuilder":
        self._kw["threads"] = n
        return self

    def tmpdir(self, path) -> "TwoSetBuilder":
        self._kw["tmpdir"] = path
        return self

    def seed(self, seed: Optional[int]) -> "TwoSetBuilder":
        self._kw["seed"] = seed
        return self

    def platform(self, platform: Platform | str) -> "TwoSetBuilder":
        if isinstance(platform, str):
            platform = Platform.from_str(platform)
        self._kw["platform"] = platform
        return self

    def engine(self, engine: str) -> "TwoSetBuilder":
        """"host" (default; writes overlaps.paf) or "device" (accelerator
        counting pipeline; PAF side-output only with device_paf)."""
        self._kw["engine"] = engine
        return self

    def device_paf(self, yes: bool) -> "TwoSetBuilder":
        """Write overlaps.paf on device runs (host re-map of mapped
        rows; the CLI sets this for -C/-D)."""
        self._kw["device_paf"] = yes
        return self

    def build(self, input_path) -> TwoSetStrategy:
        return TwoSetStrategy(input_path, **self._kw)
