"""Multi-host runtime: ``jax.distributed`` init + lockstep counting.

The reference is single-host only (SURVEY.md C16); this runtime shards
the target index across hosts.  Design:

* every process runs the same CLI on the same input: subsampling is
  seeded and deterministic, so all processes derive the SAME
  target/query split and build the SAME host index (replicated build —
  the index is small next to the read file; the DEVICE copy is what is
  sharded);
* the mesh is ``(data = n_processes, index = local chips)`` over the
  global device list, so the target index shards over every chip of
  every host and **query I/O is sharded per host**: process ``p`` only
  sketches/dispatches rows of its contiguous slice;
* dispatches run in **lockstep**: each process computes the full
  per-process schedule (it knows every slice deterministically) and
  all processes enter the same jitted collective program the same
  number of times, padding with empty rows where slices are uneven;
* per-query counts come back sharded over "data"; each process
  recomputes its own fallback rows on its local host engine, then a
  ``process_allgather`` assembles the global count vector on every
  host — the median is computed identically everywhere and host 0
  prints (`cli.py` gates output on ``jax.process_index() == 0``).

Env contract (all three required to activate, mirroring
``jax.distributed.initialize``):

* ``LRGE_COORDINATOR`` — ``host:port`` of process 0
* ``LRGE_NUM_PROCESSES`` — world size
* ``LRGE_PROCESS_ID`` — this process's rank
"""

from __future__ import annotations

import logging
import os

import numpy as np

logger = logging.getLogger("lrge")

_INITIALIZED = False


def init_from_env() -> bool:
    """Env-gated ``jax.distributed.initialize``; returns True when this
    process is part of a multi-process run.  Must be called before any
    JAX computation (the CLI calls it first thing)."""
    global _INITIALIZED
    coord = os.environ.get("LRGE_COORDINATOR")
    if not coord:
        return False
    if _INITIALIZED:
        return True
    nproc = int(os.environ["LRGE_NUM_PROCESSES"])
    pid = int(os.environ["LRGE_PROCESS_ID"])
    import jax

    jax.distributed.initialize(
        coordinator_address=coord, num_processes=nproc, process_id=pid
    )
    _INITIALIZED = True
    logger.info(
        "distributed runtime: process %d/%d, %d local / %d global devices",
        pid, nproc, len(jax.local_devices()), len(jax.devices()),
    )
    return True


def is_multihost() -> bool:
    import jax

    return _INITIALIZED and jax.process_count() > 1


def process_slice(n: int, pid: int, nproc: int) -> tuple[int, int]:
    """Contiguous [start, end) of rows owned by process ``pid``."""
    base, rem = divmod(n, nproc)
    start = pid * base + min(pid, rem)
    return start, start + base + (1 if pid < rem else 0)


def _local_rows(arr, pid: int, b_loc: int) -> np.ndarray:
    """This process's rows of a ``P("data")``-sharded output.

    Each process's addressable devices form one row of the
    ``(data, index)`` mesh, so any local shard holds exactly the rows
    this process contributed (replicated over "index") — no collective
    needed to read back our own results."""
    sh = arr.addressable_shards[0]
    idx = sh.index[0]
    assert idx.start == pid * b_loc and idx.stop == (pid + 1) * b_loc, (
        "data-axis rows are not process-aligned; mesh/process order skewed"
    )
    return np.asarray(sh.data)


def multihost_count_batch(dev, names: list, seqs: list):
    """Count overlaps for ALL queries across processes in lockstep.

    ``dev`` is a :class:`~lrge_tpu.device_engine.DeviceOverlapEngine`
    whose mesh spans processes (``data`` = processes).  Every process
    passes the FULL query list (deterministically identical across
    processes); each one only sketches, dispatches, and
    host-recomputes its own slice.

    The schedule is the production one — ``DeviceOverlapEngine.plan_rows``
    partitions each process's slice into long-tail/sparse host rows, a
    concurrent host share, and per-length-bucket device rows — shared
    with the single-process :meth:`count_batch` so the two paths cannot
    diverge.  Lockstep is preserved with exactly TWO small collectives
    beyond the dispatches themselves: one [n_buckets] allgather agreeing
    the per-bucket dispatch depth (host shares may differ across
    heterogeneous hosts), and one packed [2, width] allgather assembling
    the global count/had vectors at the end.  Per-dispatch results are
    read from this process's own addressable shards (outputs are
    ``P("data")``-sharded), so no per-dispatch collective runs at all.

    Returns a ``BatchCounts`` with the global counts, identical on
    every process.
    """
    import jax
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..device_engine import BatchCounts
    from ..ops.encode import encode_seq
    from ..ops.overlap_jax import minimizer_cap, sketch_many

    nproc = jax.process_count()
    pid = jax.process_index()
    mesh = dev._mesh
    n_data = mesh.devices.shape[0]
    assert n_data == nproc, "multihost mesh must put the data axis on processes"
    p = dev.params

    n = len(seqs)
    counts = np.zeros(n, dtype=np.int32)
    had = np.zeros(n, dtype=bool)
    fallback = 0

    B = dev.batch_size
    assert B % nproc == 0, "batch size must divide by process count"
    b_loc = B // nproc
    slices = [process_slice(n, q, nproc) for q in range(nproc)]
    s, e = slices[pid]
    long_rows, host_share_rows, bucket_rows = dev.plan_rows(
        seqs, range(s, e)
    )

    # ---- lockstep schedule: agree per-bucket dispatch depth ----
    # plan_rows is deterministic per process but host shares scale with
    # each host's cores, so depths can differ; one tiny allgather fixes
    # the global depth and everyone pads with empty dispatches.
    buckets = list(dev.length_buckets)
    my_disp = np.array(
        [(len(bucket_rows.get(L, ())) + b_loc - 1) // b_loc for L in buckets],
        dtype=np.int32,
    )
    n_disp = np.asarray(multihost_utils.process_allgather(my_disp)).max(axis=0)

    # ---- local host work (long tail + host share) runs concurrently ----
    from concurrent.futures import ThreadPoolExecutor

    host_rows_all = long_rows + host_share_rows
    pool = ThreadPoolExecutor(1) if host_rows_all else None
    host_future = (
        pool.submit(
            dev._host_count_many, [(names[i], seqs[i]) for i in host_rows_all]
        )
        if host_rows_all
        else None
    )

    # ---- lockstep device dispatches (async; collect after enqueue) ----
    data_sh = NamedSharding(mesh, P("data", None))
    data_sh1 = NamedSharding(mesh, P("data"))
    mk = lambda sh, x: jax.make_array_from_process_local_data(
        sh, np.ascontiguousarray(x)
    )
    retry = []
    inflight = []
    for bi, L in enumerate(buckets):
        depth = int(n_disp[bi])
        if depth == 0:
            continue
        A = dev.anchor_capacity(L)
        M = minimizer_cap(L)
        rows_b = bucket_rows.get(L, [])
        for d in range(depth):
            block = rows_b[d * b_loc : (d + 1) * b_loc]
            ids = np.full(b_loc, -1, np.int64)
            ids[: len(block)] = block
            lengths = np.array(
                [len(seqs[i]) if i >= 0 else 0 for i in ids], np.int32
            )
            qd = np.array(
                [dev.host._dual_rank(names[i]) if (p.no_dual and i >= 0) else 0
                 for i in ids],
                np.int32,
            )
            qs = dev._self_ranks(
                [names[i] if i >= 0 else b"\x00__pad" for i in ids]
            )
            codes = None
            if dev.pb_mode:
                q0_l, q1_l, mps_l, mc = dev._pb_planes(
                    [seqs[i] if i >= 0 else b"" for i in ids], M
                )
            else:
                codes = np.full((b_loc, L), 4, np.uint8)
                for r, i in enumerate(ids):
                    if i >= 0:
                        codes[r, : lengths[r]] = encode_seq(seqs[i])
                mh, mp, ms, mc_d = jax.device_get(
                    sketch_many(
                        jnp.asarray(codes[None]), jnp.asarray(lengths[None]),
                        k=p.k, w=p.w,
                    )
                )
                q0_l, mps_l = mh[0], mp[0] * 2 + ms[0]
                q1_l = np.zeros((b_loc, 1), np.int32)
                mc = mc_d[0]
            c, a, r, _pr = dev._sharded_fn_for(A)(
                dev._idx_tree,
                mk(data_sh, q0_l),
                mk(data_sh, q1_l),
                mk(data_sh, mps_l),
                mk(data_sh1, lengths),
                mk(data_sh1, qd),
                mk(data_sh1, qs),
                jnp.int32(dev.sharded.mid_occ),
                jnp.float32(p.chn_pen_gap()),
            )
            inflight.append((ids, lengths, codes, mc, A, M, c, a, r))

    for ids, lengths, codes, mc, A, M, c, a, r in inflight:
        c_l = _local_rows(c, pid, b_loc)
        a_l = _local_rows(a, pid, b_loc)
        r_l = _local_rows(r, pid, b_loc)
        live = ids >= 0
        needs = dev.triage_flags(live, a_l, A, r_l, mc, M, codes, lengths)
        retry.extend(ids[needs].tolist())
        ok = live & ~needs
        counts[ids[ok]] = c_l[ok]
        had[ids[ok]] = c_l[ok] > 0

    # ---- local exact recompute of flagged rows ----
    for i, (cn, h) in zip(
        retry, dev._host_count_many([(names[i], seqs[i]) for i in retry])
    ):
        counts[i], had[i] = cn, h
        fallback += 1
    if host_future is not None:
        share_set = set(host_share_rows)
        for i, (cn, h) in zip(host_rows_all, host_future.result()):
            counts[i], had[i] = cn, h
            if i in share_set:
                dev.fallback_triggers["host_share"] += 1
            else:
                fallback += 1
        pool.shutdown()

    # ---- assemble the global vector on every host (one allgather) ----
    width = max(en - st for st, en in slices)
    mine = np.zeros((2, width), np.int32)
    mine[0, : e - s] = counts[s:e]
    mine[1, : e - s] = had[s:e]
    packed = np.asarray(multihost_utils.process_allgather(mine))
    for q, (st, en) in enumerate(slices):
        counts[st:en] = packed[q, 0, : en - st]
        had[st:en] = packed[q, 1, : en - st].astype(bool)
    return BatchCounts(counts, had, fallback)
