#!/usr/bin/env python3
"""GPU smoke test of the device overlap pipeline.

Drives the CLI's device path through the normal entry points at the
full size of the reference's default two-set run on a bacterial genome
(4.4 Mbp genome, ONT preset, T=10,000 target and Q=5,000 query reads,
gamma read lengths with mean 2.5 kb and ~5% substitutions; the corpus
is bench.py's genome and read model, made from a seed), and holds it to
the exact host engine: byte-identical stdout and identical per-read
estimates.  Then runs the PacBio (``-P pb``), all-vs-all (``-n``),
``--use-min-ref`` and ``-F`` modes on the device at T=2,000/Q=1,000,
each against the host engine, and compares the device programs'
arithmetic (sketch, log2, gap penalty) with the host references.

Prints phase walls, compile/cache-load time, the chain DP's share of a
dispatch and the device and host counting rates, each with the card's
name and power limit.  The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

    python chip_smoke.py               # one GPU
    python chip_smoke.py --four-gpus   # four GPUs: the index sharded
                                       # 4 ways in one process, and
                                       # 4 processes, one per card

Exits non-zero, printing no result line, when JAX finds no GPU.  One
JAX process holds the card at a time: the CLI runs are subprocesses
that finish before this process first touches the GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

MAIN_T, MAIN_Q = 10_000, 5_000
MODE_T, MODE_Q = 2_000, 1_000
CORPUS_READS = 20_000
GENOME_SIZE = 4_400_000
SEED = 42
MIN_DEVICE_SHARE = 0.9


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def base_env(**extra) -> dict:
    """Subprocess environment: the caller's, minus any LRGE_* tuning
    (the smoke test runs the defaults), plus ``extra``."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("LRGE_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


@contextlib.contextmanager
def host_share_off():
    """Let the device count every row it can (no host share)."""
    os.environ["LRGE_HOST_SHARE"] = "0"
    try:
        yield
    finally:
        del os.environ["LRGE_HOST_SHARE"]


def probe_backend() -> dict:
    """Ask JAX, in a child process, which backend it finds (so this
    process stays off the card while the CLI runs use it)."""
    code = (
        "import json, jax; d = jax.devices(); print(json.dumps({"
        "'platform': jax.default_backend(), 'kind': d[0].device_kind, "
        "'count': len(d)}))"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], env=base_env(), capture_output=True,
        text=True, timeout=300,
    )
    if res.returncode != 0:
        raise SmokeFailure(f"JAX probe failed: {res.stderr[-2000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def write_corpus(path: str, n_reads: int, seed: int) -> None:
    """bench.py's repeat-bearing genome and read model, as FASTQ."""
    from bench import make_genome, make_reads

    rng = np.random.default_rng(seed)
    genome = make_genome(rng, GENOME_SIZE)
    reads = make_reads(rng, genome, n_reads, 2500, 0.05)
    with open(path, "wb") as fh:
        for i, seq in enumerate(reads):
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, seq, b"I" * len(seq)))


def run_cli(args, label, card, **env):
    """One ``python -m lrge_tpu`` run; returns (stdout, stderr, wall)."""
    cmd = [sys.executable, "-m", "lrge_tpu", *map(str, args)]
    t0 = time.perf_counter()
    res = subprocess.run(
        cmd, env=base_env(**env), cwd=REPO, capture_output=True, text=True,
        timeout=900,
    )
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise SmokeFailure(f"{label}: exit {res.returncode}\n{res.stderr[-3000:]}")
    log(f"phase={label} wall_s={wall:.2f} card=[{card}]")
    return res.stdout, res.stderr, wall


def device_log_summary(stderr: str, label: str) -> str:
    """Fail unless the -v log shows the device pipeline ran; return
    its fallback summary."""
    check(
        "device path phases" in stderr,
        f"{label}: the device pipeline never ran (host engine used)",
    )
    check(
        "needs mapping coordinates on the host" not in stderr,
        f"{label}: -F fell back to the host engine",
    )
    warm = re.findall(r"warmup: (\d+) bucket programs compiled or loaded in ([\d.]+)s", stderr)
    fb = re.findall(r"device path: (\d+)/(\d+) rows fell back to host \((.*)\)", stderr)
    out = [f"warmup_s={sum(float(t) for _, t in warm):.2f}"]
    if fb:
        out.append(f"host_rows={sum(int(a) for a, _, _ in fb)}/{sum(int(b) for _, b, _ in fb)}")
        out.append(f"triggers={fb[-1][2]}")
    else:
        out.append("host_rows=0")
    return " ".join(out)


def phase_cli_pair(fq, args, label, card, ncpu):
    """Device run with no host share (``-v`` log checked), then host
    run; stdout must match."""
    common = [fq, *args, "-s", SEED, "-t", ncpu]
    d_out, d_err, _ = run_cli(
        [*common, "--engine", "device", "-v"], f"{label}/device", card,
        LRGE_HOST_SHARE="0",
    )
    summary = device_log_summary(d_err, label)
    h_out, _, _ = run_cli(
        [*common, "--engine", "host"], f"{label}/host", card, JAX_PLATFORMS="cpu"
    )
    check(d_out == h_out, f"{label}: device stdout {d_out!r} != host {h_out!r}")
    log(f"{label}: stdout {d_out.strip()} == host; device {summary}")
    return d_out


def kernel_checks(card: str) -> None:
    """Device programs vs their plain host references at real widths."""
    import jax
    import jax.numpy as jnp

    from lrge_tpu.ops.chain import gap_penalty, mg_log2
    from lrge_tpu.ops.encode import make_batches
    from lrge_tpu.ops.overlap_jax import gap_penalty_jax, mg_log2_jax, sketch_many
    from lrge_tpu.ops.sketch import needs_scalar_sketch, sketch_read
    from lrge_tpu.platform import Platform, preset_for

    t0 = time.perf_counter()
    # the f32 log2 may differ in its last bits (the compiler may fuse
    # multiply-adds); only the truncated integer penalty must agree
    x = np.arange(1, 1 << 17, dtype=np.float32)
    got = np.asarray(jax.jit(mg_log2_jax)(jnp.asarray(x)))
    n_ulp = int((got != mg_log2(x)).sum())
    for plat in (Platform.NANOPORE, Platform.PACBIO):
        p = preset_for(plat, dual=True)
        dd = np.arange(0, 2 * p.bw + 2, dtype=np.int64)
        pen_gap = np.float32(p.chn_pen_gap())
        dev = np.asarray(
            jax.jit(gap_penalty_jax)(jnp.asarray(dd, jnp.int32), jnp.float32(pen_gap))
        )
        host = gap_penalty(dd, np.zeros_like(dd), pen_gap, np.float32(0.0))
        bad = np.flatnonzero(dev != host)
        check(bad.size == 0, f"gap penalty differs ({plat}): dd={dd[bad[:8]]}")
    # sketch: one super-batch of bench-model reads at the 4096 bucket
    from bench import make_genome, make_reads

    rng = np.random.default_rng(SEED)
    reads = make_reads(rng, make_genome(rng, GENOME_SIZE), 256, 2500, 0.05)
    reads = [r[:4096] for r in reads]
    p = preset_for(Platform.NANOPORE, dual=True)
    batches = make_batches(reads, batch_size=128, pad_to=4096, pad_batch=True)
    codes = np.stack([b.codes for b in batches])
    lens = np.stack([b.lengths for b in batches])
    ids = np.stack([b.ids for b in batches])
    mh, mp, ms, mc = map(np.asarray, sketch_many(jnp.asarray(codes), jnp.asarray(lens),
                                                  k=p.k, w=p.w))
    n_cmp = 0
    for g in range(codes.shape[0]):
        for r in range(codes.shape[1]):
            if ids[g, r] < 0:
                continue
            row = codes[g, r, : lens[g, r]]
            if needs_scalar_sketch(row, p.k, p.w, False) or mc[g, r] > mh.shape[-1]:
                continue  # the engine recomputes these rows on the host
            mz = sketch_read(row, p.k, p.w, False)
            c = mc[g, r]
            check(
                c == len(mz.key)
                and np.array_equal(mh[g, r, :c], (mz.key >> np.uint64(8)).astype(np.uint32))
                and np.array_equal(mp[g, r, :c], mz.pos)
                and np.array_equal(ms[g, r, :c], mz.strand),
                f"device sketch differs from host on read {ids[g, r]}",
            )
            n_cmp += 1
    check(n_cmp > 200, f"only {n_cmp} sketch rows compared")
    log(f"kernels: gap penalty (ONT+PB, dd<=2bw) and sketch ({n_cmp} reads "
        f"x 4096) equal to host; f32 log2 differs in the last bits on "
        f"{n_ulp}/{x.size} inputs; "
        f"wall_s={time.perf_counter() - t0:.2f} card=[{card}]")


def stage_wall(engine, names, seqs, stage: str) -> tuple[float, float]:
    """(warmup s, best enqueue+collect s of 2 passes) with the fused
    program truncated after ``stage`` ("" = the whole pipeline)."""
    import lrge_tpu.ops.overlap_jax as oj

    orig = oj.sketch_map_many
    if stage:
        oj.sketch_map_many = functools.partial(orig, profile_stage=stage)
    try:
        t0 = time.perf_counter()
        engine.warmup([len(s) for s in seqs])
        t_warm = time.perf_counter() - t0
        best = float("inf")
        for _ in range(2):
            engine.count_batch(names, seqs)
            ph = engine.last_phases
            best = min(best, ph["enqueue"] + ph["collect"])
    finally:
        oj.sketch_map_many = orig
    return t_warm, best


def in_process_main(fq: str, card: str, ncpu: int, tmp: str) -> None:
    """Strategy-level equality and engine-level routes, rates, compile
    time and the DP share, all on the main-phase deployment."""
    import jax

    from lrge_tpu.device_engine import DeviceOverlapEngine, resolve_engine
    from lrge_tpu.engine import fork_unsafe
    from lrge_tpu.ops.index import build_index
    from lrge_tpu.platform import Platform, preset_for
    from lrge_tpu.strategy.twoset import TwoSetStrategy
    from lrge_tpu.utils.jaxcache import cache_dir, cache_stats, enable_cache

    enable_cache()
    check(jax.default_backend() == "gpu", "in-process backend is not the GPU")
    check(resolve_engine("auto", MAIN_Q) == "device",
          "resolve_engine('auto', 5000) did not pick the device")
    kernel_checks(card)
    check(fork_unsafe(), "fork_unsafe() is False with the GPU backend up")

    with host_share_off():
        t0 = time.perf_counter()
        est_d, nm_d = TwoSetStrategy(
            fq, target_num_reads=MAIN_T, query_num_reads=MAIN_Q, seed=SEED,
            tmpdir=os.path.join(tmp, "sd"), threads=ncpu, engine="device",
        ).generate_estimates()
        t_d = time.perf_counter() - t0
    t0 = time.perf_counter()
    est_h, nm_h = TwoSetStrategy(
        fq, target_num_reads=MAIN_T, query_num_reads=MAIN_Q, seed=SEED,
        tmpdir=os.path.join(tmp, "sh"), threads=ncpu, engine="host",
    ).generate_estimates()
    t_h = time.perf_counter() - t0
    check(nm_d == nm_h, f"no-mapping counts differ: device {nm_d} host {nm_h}")
    check(np.array_equal(np.asarray(est_d), np.asarray(est_h), equal_nan=True),
          "per-read estimates differ between device and host strategies")
    log(f"strategy: {len(est_d)} per-read estimates array_equal; "
        f"device_wall_s={t_d:.2f} host_wall_s={t_h:.2f} card=[{card}]")

    # engine level: the same split, driven directly
    strat = TwoSetStrategy(fq, target_num_reads=MAIN_T, query_num_reads=MAIN_Q,
                           seed=SEED, tmpdir=os.path.join(tmp, "se"))
    targets, queries, _ = strat.split_fastq()
    index = build_index([s for _, s in targets], [n for n, _ in targets],
                        preset_for(Platform.NANOPORE, dual=True))
    names = [n for n, _ in queries]
    seqs = [s for _, s in queries]
    with host_share_off():
        eng = DeviceOverlapEngine(index)
        _, t_full = stage_wall(eng, names, seqs, "")
        eng.fallback_triggers.clear()
        t0 = time.perf_counter()
        res = eng.count_batch(names, seqs)
        t_map = time.perf_counter() - t0
        trig = dict(eng.fallback_triggers)
        host_rows = res.fallback_rows + trig.get("host_share", 0)
        dev_rows = len(seqs) - host_rows
        log(f"rows by route: device={dev_rows} host_fallback={res.fallback_rows} "
            f"by_trigger={ {k: v for k, v in trig.items() if k != 'host_share'} } "
            f"host_share={trig.get('host_share', 0)} of {len(seqs)}")
        check(dev_rows >= MIN_DEVICE_SHARE * len(seqs),
              f"device counted {dev_rows}/{len(seqs)} queries (< 90%)")
        items = list(zip(names, seqs))
        t0 = time.perf_counter()
        host_counts = [c for c, _ in eng.host.count_overlaps_many(items)]
        t_host = time.perf_counter() - t0
        check(np.array_equal(res.counts, host_counts), "engine counts differ from host")
        dev_rate = len(seqs) / t_map
        core_rate = len(seqs) / t_host / ncpu
        log(f"rates: device-only map {t_map:.3f}s ({dev_rate:.1f} q/s, "
            f"dp_chunk={eng.dp_chunk}); native host {t_host:.3f}s on {ncpu} cores "
            f"({core_rate:.1f} q/s/core); r=host_per_core/device={core_rate / dev_rate:.4f} "
            f"card=[{card}]")
        stages = {}
        for stage in ("sort", "dp"):
            t_w, stages[stage] = stage_wall(eng, names, seqs, stage)
            log(f"compile (fused program cut after {stage}): {t_w:.2f}s card=[{card}]")
        dp = stages["dp"] - stages["sort"]
        log(f"dispatch walls (enqueue+collect, all super-batches): to_sort={stages['sort']:.3f}s "
            f"to_dp={stages['dp']:.3f}s full={t_full:.3f}s; chain DP share="
            f"{dp / t_full:.3f} reduce share={(t_full - stages['dp']) / t_full:.3f} "
            f"card=[{card}]")
    log(f"persistent cache this process: {cache_stats()} dir={cache_dir()}")


def run_one_gpu(fq: str, card: str, ncpu: int, tmp: str) -> None:
    t0 = time.perf_counter()
    phase_cli_pair(fq, ["-T", MAIN_T, "-Q", MAIN_Q], "main", card, ncpu)
    modes = [
        ("pb", ["-T", MODE_T, "-Q", MODE_Q, "-P", "pb"]),
        ("ava", ["-n", MODE_T]),
        ("min-ref", ["-T", MODE_T, "-Q", MODE_Q, "--use-min-ref"]),
        ("filter", ["-T", MODE_T, "-Q", MODE_Q, "-F"]),
    ]
    for label, args in modes:
        phase_cli_pair(fq, args, label, card, ncpu)
    in_process_main(fq, card, ncpu, tmp)
    log(f"one-gpu phases wall_s={time.perf_counter() - t0:.2f} card=[{card}]")


def run_four_gpus(fq: str, card: str, ncpu: int, tmp: str) -> None:
    """The 4-way sharded index: (b) 4 processes, one card each, rank 0's
    stdout vs the host engine; then (a) one process over 4 cards,
    per-read estimates vs the host strategy."""
    args = [fq, "-T", MAIN_T, "-Q", MAIN_Q, "-s", SEED, "-t", ncpu]
    want, _, _ = run_cli([*args, "--engine", "host"], "four/host", card,
                         JAX_PLATFORMS="cpu")
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    t0 = time.perf_counter()
    procs = []
    # each rank logs to files: ranks block in collectives on each
    # other, so a rank stalled on a full stdout/stderr pipe would stall
    # them all
    logs = [(os.path.join(tmp, f"rank{pid}.out"), os.path.join(tmp, f"rank{pid}.err"))
            for pid in range(4)]
    try:
        for pid, (o, e) in enumerate(logs):
            env = base_env(
                CUDA_VISIBLE_DEVICES=str(pid), LRGE_COORDINATOR=f"localhost:{port}",
                LRGE_NUM_PROCESSES="4", LRGE_PROCESS_ID=str(pid), LRGE_HOST_SHARE="0",
            )
            with open(o, "w") as fo, open(e, "w") as fe:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "lrge_tpu", *map(str, args),
                     "--engine", "device", "-v"],
                    env=env, cwd=REPO, stdout=fo, stderr=fe,
                ))
        for p in procs:
            p.wait(timeout=900)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    outs = []
    for pid, (p, (o, e)) in enumerate(zip(procs, logs)):
        with open(o) as fo, open(e) as fe:
            out, err = fo.read(), fe.read()
        check(p.returncode == 0, f"four/process {pid}: exit {p.returncode}\n{err[-3000:]}")
        outs.append((out, err))
    wall = time.perf_counter() - t0
    # keep the estimate lines only: a collectives backend may log to
    # stdout in some builds
    est_lines = lambda text: [ln for ln in text.splitlines() if ln.strip().isdigit()]
    check(est_lines(outs[0][0]) == est_lines(want) != [],
          f"4-process rank 0 stdout {outs[0][0]!r} != host {want!r}")
    check(all(est_lines(o) == [] for o, _ in outs[1:]), "non-zero ranks printed an estimate")
    mesh = re.findall(r"sharded over (\d+) devices \((\d+)x(\d+) mesh\)", outs[0][1])
    log(f"four/4-process: rank0 stdout {want.strip()} == host; mesh={mesh} "
        f"wall_s={wall:.2f} card=[{card}]")

    import jax

    from lrge_tpu.strategy.twoset import TwoSetStrategy

    check(jax.default_backend() == "gpu" and len(jax.devices()) == 4,
          f"need 4 GPUs in one process, found {jax.devices()}")
    import logging

    class Grab(logging.Handler):
        def __init__(self):
            super().__init__(logging.DEBUG)
            self.msgs = []

        def emit(self, record):
            self.msgs.append(record.getMessage())

    lg, grab = logging.getLogger("lrge"), Grab()
    level = lg.level
    lg.setLevel(logging.DEBUG)
    lg.addHandler(grab)
    os.environ["LRGE_HOST_SHARE"] = "0"
    try:
        t0 = time.perf_counter()
        est_d, nm_d = TwoSetStrategy(
            fq, target_num_reads=MAIN_T, query_num_reads=MAIN_Q, seed=SEED,
            tmpdir=os.path.join(tmp, "fd"), threads=ncpu, engine="device",
        ).generate_estimates()
        t_d = time.perf_counter() - t0
    finally:
        del os.environ["LRGE_HOST_SHARE"]
        lg.removeHandler(grab)
        lg.setLevel(level)
    mesh1 = [m for m in grab.msgs if "sharded over" in m]
    check(mesh1 == ["device engine: sharded over 4 devices (1x4 mesh)"],
          f"one-process engine was not sharded 4 ways: {mesh1}")
    est_h, nm_h = TwoSetStrategy(
        fq, target_num_reads=MAIN_T, query_num_reads=MAIN_Q, seed=SEED,
        tmpdir=os.path.join(tmp, "fh"), threads=ncpu, engine="host",
    ).generate_estimates()
    check(nm_d == nm_h and np.array_equal(np.asarray(est_d), np.asarray(est_h),
                                          equal_nan=True),
          "4-way sharded per-read estimates differ from host")
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0) for d in jax.devices()]
    check(min(peaks) > 0, f"a device did no work: peak bytes {peaks}")
    log(f"four/1-process {mesh1[0]}: {len(est_d)} per-read estimates array_equal host; "
        f"peak_bytes_per_device={peaks} wall_s={t_d:.2f} card=[{card}]")


def gpu_card() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        raise SmokeFailure(f"nvidia-smi unavailable: {e}")
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-GPU sharded-index checks")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    try:
        dev = probe_backend()
        if dev["platform"] != "gpu":
            print(f"[smoke] FAIL: JAX found no GPU (backend {dev['platform']!r})",
                  file=sys.stderr)
            return 2
        smi = gpu_card()
        print(smi, flush=True)
        card = smi.splitlines()[0] + (f" x{dev['count']}" if dev["count"] > 1 else "")
        log(f"jax device: {dev}")
        from lrge_tpu.native import HAVE_NATIVE

        check(HAVE_NATIVE, "native host extension unavailable (build failed)")
        ncpu = os.cpu_count() or 1
        with tempfile.TemporaryDirectory(prefix="lrge-smoke-") as tmp:
            fq = os.path.join(tmp, "reads.fq")
            t0 = time.perf_counter()
            write_corpus(fq, CORPUS_READS, SEED)
            log(f"corpus: {CORPUS_READS} reads, {GENOME_SIZE} bp genome, "
                f"wall_s={time.perf_counter() - t0:.2f}")
            if args.four_gpus:
                check(dev["count"] == 4, f"--four-gpus needs 4 GPUs, found {dev['count']}")
                run_four_gpus(fq, card, ncpu, tmp)
            else:
                run_one_gpu(fq, card, ncpu, tmp)
        import jax

        d = jax.devices()
        result = {"ok": True, "device": {"platform": d[0].platform,
                                         "kind": d[0].device_kind, "count": len(d)}}
    except SmokeFailure as e:
        print(f"[smoke] FAIL: {e}", file=sys.stderr)
        return 1
    print(smi, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
