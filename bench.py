"""Benchmark: query-reads/s through the device overlap pipeline.

Measures the two-set hot loop (the reference's `mm_map` equivalent) on
synthetic ONT-like reads: 10k-target index, batches of queries mapped on
device, per-read estimates computed from the counts.  Prints one JSON
line: {"metric", "value", "unit", "vs_baseline"}.

Baseline context (BASELINE.md): the reference's published run maps 5k
queries against a 10k index in ~17 s wall on an 8-thread CPU
(~300 query-reads/s); the driver target is >=5x a 16-thread CPU run.
We report absolute query-reads/s and vs_baseline against 600 reads/s
(a 16-thread CPU lrge estimate: 2x the 8-thread published rate).
"""

import json
import os
import sys
import time

import numpy as np

# Baseline: the reference's published run (BASELINE.md) maps Q=5000
# against a T=10000 index in ~17 s wall on 8 CPU threads, including
# two IO passes and the minimap2 index build; attributing ~60% of the
# wall to mapping gives ~290 q/s at 8 threads, doubled for the
# driver's 16-thread target -> ~600 q/s.  This is a documented
# estimate, not a measurement (no Rust toolchain in this image).
BASELINE_QPS = 600.0


def make_reads(rng, genome, n, mean_len, err):
    lens = np.clip(rng.gamma(3.0, mean_len / 3.0, size=n).astype(int), 500, 30_000)
    rc = bytes.maketrans(b"ACGT", b"TGCA")
    reads = []
    g = np.frombuffer(genome, dtype=np.uint8)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    for L in lens:
        L = int(min(L, len(genome) - 1))
        pos = int(rng.integers(0, len(genome) - L))
        arr = g[pos : pos + L].copy()
        nerr = rng.binomial(L, err)
        if nerr:
            sites = rng.integers(0, L, size=nerr)
            arr[sites] = bases[rng.integers(0, 4, size=nerr)]
        seq = arr.tobytes()
        if rng.integers(0, 2):
            seq = seq.translate(rc)[::-1]
        reads.append(seq)
    return reads


def make_genome(rng, genome_size):
    """Random genome with repeat structure (the hard case for chaining
    heuristics and the occurrence filter): a dispersed 2 kb family
    (5 copies) and a tandem 400 bp x 5 block."""
    genome = np.frombuffer(
        rng.integers(0, 4, size=genome_size, dtype=np.uint8), dtype=np.uint8
    )
    genome = bytearray(np.frombuffer(b"ACGT", dtype=np.uint8)[genome].tobytes())
    fam = bytes(genome[100_000:102_000])
    for c in range(5):
        pos = 500_000 + c * 700_000
        genome[pos : pos + 2_000] = fam
    unit = bytes(genome[200_000:200_400])
    genome[300_000:302_000] = unit * 5
    return bytes(genome)


def gpu_identity():
    """The card's name and power limit as nvidia-smi reports them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip() or f"nvidia-smi failed ({out.stderr.strip()})"


def main():
    n_targets = int(os.environ.get("BENCH_TARGETS", 10_000))
    n_queries = int(os.environ.get("BENCH_QUERIES", 5_000))
    genome_size = int(os.environ.get("BENCH_GENOME", 4_400_000))
    err = float(os.environ.get("BENCH_ERR", 0.05))

    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"[bench] no GPU: JAX backend is {jax.default_backend()!r}; "
            "device timings need the card"
        )
    dev0 = jax.devices()[0]
    device = {
        "platform": dev0.platform,
        "kind": dev0.device_kind,
        "count": len(jax.devices()),
        "nvidia_smi": gpu_identity(),
    }
    print(f"[bench] device: {device}", file=sys.stderr)

    from lrge_tpu.device_engine import DeviceOverlapEngine
    from lrge_tpu.utils.jaxcache import cache_stats, enable_cache

    enable_cache()
    from lrge_tpu.estimate import median, per_read_estimate_batch
    from lrge_tpu.ops.index import build_index
    from lrge_tpu.platform import Platform, preset_for

    rng = np.random.default_rng(6)
    print(f"[bench] genome={genome_size} targets={n_targets} queries={n_queries}", file=sys.stderr)
    genome = make_genome(rng, genome_size)
    targets = make_reads(rng, genome, n_targets, 2500, err)
    queries = make_reads(rng, genome, n_queries, 2500, err)
    tnames = [b"t%d" % i for i in range(n_targets)]
    qnames = [b"q%d" % i for i in range(n_queries)]

    params = preset_for(Platform.NANOPORE, dual=True)
    # index build first: its fork pool must run before the JAX backend
    # spins up threads
    t0 = time.perf_counter()
    index = build_index(targets, tnames, params)
    t_index = time.perf_counter() - t0
    print(f"[bench] index build: {t_index:.2f}s ({len(index.keys)} postings)", file=sys.stderr)

    engine = DeviceOverlapEngine(index, batch_size=128, num_anchors=4096, window=int(os.environ.get("BENCH_WINDOW", 32)))
    t_w = time.perf_counter()
    # compile only the buckets this query set will actually dispatch
    engine.warmup([len(q) for q in queries])
    t_warm = time.perf_counter() - t_w
    print(f"[bench] warmup/compile: {t_warm:.1f}s", file=sys.stderr)

    # throughput = best of BENCH_REPS steady-state passes; ALL pass
    # times and the median are reported alongside
    reps = int(os.environ.get("BENCH_REPS", 3))

    def measure(discard_first=False, **kw):
        times, best_res = [], None
        for i in range(reps + (1 if discard_first else 0)):
            t1 = time.perf_counter()
            r = engine.count_batch(qnames, queries, **kw)
            dt = time.perf_counter() - t1
            if discard_first and i == 0:
                continue  # compile pass
            if not times or dt < min(times):
                best_res = r
            times.append(dt)
        return times, best_res

    # device-only throughput first (host-share disabled): the card's
    # own rate, never credited with host cores
    os.environ["LRGE_HOST_SHARE"] = "0"
    dev_times, res_dev = measure()
    t_dev = min(dev_times)
    dev_qps = n_queries / t_dev
    # valid anchors chained per second and [B, A] slot occupancy
    anchors_valid = engine.last_anchors_valid
    anchor_slots = engine.last_anchor_slots
    anchors_per_s = anchors_valid / t_dev
    print(
        f"[bench] device-only map: {t_dev:.2f}s ({dev_qps:.0f} q/s), "
        f"median {np.median(dev_times):.2f}s, fallback={res_dev.fallback_rows}, "
        f"anchors/s={anchors_per_s/1e6:.1f}M occ={anchors_valid/max(anchor_slots,1):.2f}",
        file=sys.stderr,
    )

    # fused-vs-unfused A/B (device-only): the unfused split dispatches
    # share none of the fused program, so the two rates separate a
    # fused-path change from everything else.  First unfused pass
    # compiles and is discarded.  BENCH_AB=0 skips.
    ab_times = []
    if os.environ.get("BENCH_AB", "1") == "1":
        os.environ["LRGE_NO_FUSED"] = "1"
        try:
            ab_times, res_ab = measure(discard_first=True)
        finally:
            del os.environ["LRGE_NO_FUSED"]
        if not np.array_equal(res_ab.counts, res_dev.counts):
            raise SystemExit("[bench] FATAL: unfused counts != fused counts")
        print(
            f"[bench] unfused A/B: best {min(ab_times):.2f}s "
            f"({n_queries/min(ab_times):.0f} q/s), median {np.median(ab_times):.2f}s",
            file=sys.stderr,
        )
    del os.environ["LRGE_HOST_SHARE"]

    map_times, res = measure()
    t_map = min(map_times)
    qps = n_queries / t_map
    # wall to first result: index + compile + one mapping pass (the
    # extra best-of passes are measurement, not pipeline work)
    t_total = t_index + t_warm + t_map

    # silent-regression tripwire: the heterogeneous run, the device-only
    # run, and the exact host engine must agree on counts (sampled)
    if not np.array_equal(res.counts, res_dev.counts):
        raise SystemExit("[bench] FATAL: host-share run counts != device-only counts")
    sample = np.random.default_rng(0).choice(n_queries, size=200, replace=False)
    host_counts = [
        c for c, _ in engine.host.count_overlaps_many(
            [(qnames[i], queries[i]) for i in sample]
        )
    ]
    if not np.array_equal(res.counts[sample], host_counts):
        raise SystemExit("[bench] FATAL: device counts != host counts on sample")

    # end-to-end estimate sanity.  The ~6% overestimate on this corpus
    # is the estimator's error-rate bias, not a pipeline defect: counts
    # are host-verified identical (below), and tools/estimate_bias_probe.py
    # shows the error tracks the substitution rate (0% err -> -0.9%,
    # 2% -> +4.8%, 5% -> +8.2%) and is insensitive to the length
    # distribution — substitutions break minimizer seeds near overlap
    # ends, pushing marginal true overlaps under min_chain_score, so
    # fewer overlaps are counted and the genome-size estimate inflates.
    # The reference estimator shares this bias by construction
    # (identical counts -> identical estimates).
    sum_t = sum(len(s) for s in targets)
    avg_t = np.float32(sum_t) / np.float32(n_targets)
    ests = per_read_estimate_batch(
        np.array([len(q) for q in queries]), float(avg_t), n_targets, res.counts, 100
    )
    _, est, _ = median(ests[np.isfinite(ests)])
    err_pct = abs(est - genome_size) / genome_size * 100.0
    print(
        f"[bench] map: {t_map:.2f}s ({qps:.0f} q/s), fallback={res.fallback_rows} "
        f"{dict(engine.fallback_triggers)}, estimate={est:.0f} ({err_pct:.2f}% err)",
        file=sys.stderr,
    )
    if getattr(engine, "last_phases", None):
        ph = {k: round(v, 2) for k, v in engine.last_phases.items()}
        print(f"[bench] phases: {ph}", file=sys.stderr)

    # ---- real-read throughput (VERDICT r4 item 5) ----
    # The synthetic corpus controls the workload; this section runs the
    # SAME T=10k/Q=5k configuration on real ONT reads (toy.bam's 500
    # reads resampled, lengths 8-32,437 bp) so the JSON carries a
    # real-read q/s alongside the synthetic one.  Counts are
    # host-verified on a sample.  BENCH_REALREAD=0 skips.
    real = {}
    toy = "/root/reference/lrge/tests/data/toy.bam"
    if os.environ.get("BENCH_REALREAD", "1") == "1" and os.path.exists(toy):
        from lrge_tpu.io import iter_records

        reads = [sq for _, sq in iter_records(toy)]
        rrng = np.random.default_rng(6)
        bases = np.frombuffer(b"ACGT", dtype=np.uint8)
        # Scale: the fixture holds 500 unique reads, so the published
        # T=10k/Q=5k would stack every read ~30x AT THE SAME POSITION —
        # a repeat structure no real run has (every minimizer becomes a
        # ~30-occurrence repeat; measured: most rows overflow anchors
        # and recompute on host).  The throughput section therefore
        # runs at 4x/2x duplication (T=2000/Q=1000) with independent
        # 1.5% substitutions per copy, which keeps real length/content
        # and a sane occurrence structure; the full T=10k/Q=5k
        # configuration is exercised for PARITY (not throughput) by
        # tests/test_reference_scale.py.
        n_rt = min(n_targets, 4 * len(reads))
        n_rq = min(n_queries, 2 * len(reads))

        def resample(n):
            out = []
            for i in rrng.permutation(n * 2)[:n] % len(reads):
                arr = np.frombuffer(reads[i], dtype=np.uint8).copy()
                ne = rrng.binomial(len(arr), 0.015)
                if ne:
                    arr[rrng.integers(0, len(arr), size=ne)] = bases[
                        rrng.integers(0, 4, size=ne)
                    ]
                out.append(arr.tobytes())
            return out

        r_targets = resample(n_rt)
        r_queries = resample(n_rq)
        rt_names = [b"rt%d" % i for i in range(n_rt)]
        rq_names = [b"rq%d" % i for i in range(n_rq)]
        t0 = time.perf_counter()
        r_index = build_index(r_targets, rt_names, params)
        r_tindex = time.perf_counter() - t0
        # A = 1.5L: even at 4x the positional stacking leaves per-read
        # anchor counts ~25% above the synthetic corpus's (measured
        # ~33% overflow-fallback rows at A = L)
        r_engine = DeviceOverlapEngine(
            index=r_index,
            batch_size=128,
            num_anchors=6144,
            window=int(os.environ.get("BENCH_WINDOW", 32)),
        )
        t0 = time.perf_counter()
        r_engine.warmup([len(q) for q in r_queries])
        r_twarm = time.perf_counter() - t0
        r_times = []
        r_res = None
        for _ in range(reps):
            t1 = time.perf_counter()
            r_res = r_engine.count_batch(rq_names, r_queries)
            r_times.append(time.perf_counter() - t1)
        r_tmap = min(r_times)
        sample = np.random.default_rng(1).choice(n_rq, size=100, replace=False)
        r_host = [
            c for c, _ in r_engine.host.count_overlaps_many(
                [(rq_names[i], r_queries[i]) for i in sample]
            )
        ]
        if not np.array_equal(r_res.counts[sample], r_host):
            raise SystemExit("[bench] FATAL: real-read device counts != host")
        real = {
            "realread_qps": round(n_rq / r_tmap, 1),
            "realread_queries": n_rq,
            "realread_map_s": round(r_tmap, 3),
            "realread_index_s": round(r_tindex, 2),
            "realread_warmup_s": round(r_twarm, 1),
            "realread_fallback_rows": int(r_res.fallback_rows),
        }
        print(
            f"[bench] real reads (toy.bam resample): {r_tmap:.2f}s "
            f"({real['realread_qps']:.0f} q/s), fallback={r_res.fallback_rows}",
            file=sys.stderr,
        )

    print(
        json.dumps(
            {
                "metric": "query_reads_per_sec_per_chip",
                "value": round(qps, 1),
                "unit": "reads/s",
                "vs_baseline": round(qps / BASELINE_QPS, 2),
                "device": device,
                "extra": {
                    "estimate_bp": int(est),
                    "estimate_err_pct": round(err_pct, 3),
                    "index_build_s": round(t_index, 2),
                    # compile or cache-load time (see compile_cache)
                    "warmup_s": round(t_warm, 1),
                    "total_wall_s": round(t_total, 2),
                    "map_s": round(t_map, 2),
                    # chip-only throughput (LRGE_HOST_SHARE=0): the
                    # heterogeneous host-share split stacks on top
                    "device_only_qps": round(dev_qps, 1),
                    # best is the headline; the median and raw passes
                    # show the spread
                    "map_s_passes": [round(x, 3) for x in map_times],
                    "map_s_median": round(float(np.median(map_times)), 3),
                    "device_only_passes": [round(x, 3) for x in dev_times],
                    "device_only_qps_median": round(
                        n_queries / float(np.median(dev_times)), 1
                    ),
                    # fused-vs-unfused A/B (same card, split dispatches)
                    "ab_unfused_passes": [round(x, 3) for x in ab_times],
                    "ab_unfused_qps": (
                        round(n_queries / min(ab_times), 1) if ab_times else None
                    ),
                    # device-only pass: anchors chained per second and
                    # [B, A] slot occupancy
                    "anchors_per_s": round(anchors_per_s, 0),
                    "anchor_slot_occupancy": round(
                        anchors_valid / max(anchor_slots, 1), 3
                    ),
                    "host_fallback_rows": int(res.fallback_rows),
                    # heterogeneous split: rows deliberately counted by the
                    # native host kernel CONCURRENTLY with device execution
                    # (exact, same counts; see device_engine.py host-share)
                    "host_share_rows": int(
                        engine.fallback_triggers.get("host_share", 0)
                    ),
                    # persistent-cache effectiveness during warmup
                    "compile_cache": cache_stats(),
                    # real-read section (toy.bam resampled to T=10k/Q=5k)
                    **real,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
