"""Device pipeline vs exact host engine: counts must be identical."""

import numpy as np
import pytest

from lrge_tpu.device_engine import DeviceOverlapEngine
from lrge_tpu.engine import OverlapEngine
from lrge_tpu.ops.index import build_index
from lrge_tpu.platform import Platform, preset_for

RC = bytes.maketrans(b"ACGT", b"TGCA")


def make_reads(rng, genome, n, length, err):
    reads = []
    for i in range(n):
        pos = int(rng.integers(0, len(genome) - length))
        seq = bytearray(genome[pos : pos + length])
        for j in range(len(seq)):
            if rng.random() < err:
                seq[j] = int(rng.choice(list(b"ACGT")))
        seq = bytes(seq)
        if rng.integers(0, 2):
            seq = seq.translate(RC)[::-1]
        reads.append(seq)
    return reads


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(31337)
    genome = bytearray(rng.choice(list(b"ACGT"), size=150_000).tolist())
    # periodic repeat block (5 copies of a 400bp unit): reads covering it
    # share minimizers at several diagonals, producing the dense plateau
    # runs that fire minimap2's max_chain_skip early break
    unit = bytes(rng.choice(list(b"ACGT"), size=400).tolist())
    genome[60_000 : 60_000 + 5 * 400] = unit * 5
    genome = bytes(genome)
    # ~8% errors: realistic ONT anchor density
    targets = make_reads(rng, genome, 120, 2000, err=0.08)
    tnames = [f"t{i}".encode() for i in range(len(targets))]
    queries = make_reads(rng, genome, 40, 2500, err=0.08)
    qnames = [f"q{i}".encode() for i in range(len(queries))]
    return targets, tnames, queries, qnames


class TestDeviceVsHost:
    def test_twoset_counts_match(self, corpus):
        targets, tnames, queries, qnames = corpus
        params = preset_for(Platform.NANOPORE, dual=True)
        index = build_index(targets, tnames, params)
        host = OverlapEngine(index)
        dev = DeviceOverlapEngine(index, batch_size=16, num_anchors=4096, window=128)
        res = dev.count_batch(qnames, queries)
        for i, (nm, sq) in enumerate(zip(qnames, queries)):
            hc, hh = host.count_overlaps(nm, sq)
            assert res.counts[i] == hc, f"query {i}: device {res.counts[i]} host {hc}"
            assert bool(res.had_mapping[i]) == bool(hh)

    @pytest.mark.parametrize("dp_chunk", [1, 8])
    @pytest.mark.parametrize("window", [32, 64])
    def test_dp_chunk_and_window_counts_match(
        self, corpus, monkeypatch, dp_chunk, window
    ):
        # dp_chunk=8 is the GPU default; the unrolled DP must count
        # exactly what the host does at both production window widths
        targets, tnames, queries, qnames = corpus
        monkeypatch.setenv("LRGE_DP_CHUNK", str(dp_chunk))
        monkeypatch.setenv("LRGE_HOST_SHARE", "0")
        index = build_index(targets, tnames, preset_for(Platform.NANOPORE, dual=True))
        host = OverlapEngine(index)
        dev = DeviceOverlapEngine(index, batch_size=16, window=window)
        assert dev.dp_chunk == dp_chunk
        res = dev.count_batch(qnames, queries)
        assert res.fallback_rows < len(queries)
        for i, (nm, sq) in enumerate(zip(qnames, queries)):
            hc, hh = host.count_overlaps(nm, sq)
            assert res.counts[i] == hc, f"query {i}: device {res.counts[i]} host {hc}"
            assert bool(res.had_mapping[i]) == bool(hh)

    def test_ava_counts_match(self, corpus):
        targets, tnames, _, _ = corpus
        params = preset_for(Platform.NANOPORE, dual=False)  # no_dual set
        index = build_index(targets[:60], tnames[:60], params)
        host = OverlapEngine(index)
        dev = DeviceOverlapEngine(index, batch_size=16, num_anchors=4096, window=128)
        res = dev.count_batch(tnames[:60], targets[:60])
        for i in range(60):
            hc, hh = host.count_overlaps(tnames[i], targets[i])
            assert res.counts[i] == hc, f"read {i}: device {res.counts[i]} host {hc}"

    def test_fallback_on_dense_runs(self, corpus):
        # error-free reads produce dense anchor runs; with a tiny window
        # the engine must fall back rather than return wrong counts
        rng = np.random.default_rng(5)
        genome = bytes(rng.choice(list(b"ACGT"), size=30_000).tolist())
        targets = make_reads(rng, genome, 30, 1500, err=0.0)
        tnames = [f"d{i}".encode() for i in range(30)]
        queries = make_reads(rng, genome, 8, 1500, err=0.0)
        qnames = [f"qq{i}".encode() for i in range(8)]
        params = preset_for(Platform.NANOPORE, dual=True)
        index = build_index(targets, tnames, params)
        host = OverlapEngine(index)
        dev = DeviceOverlapEngine(index, batch_size=8, num_anchors=2048, window=16)
        res = dev.count_batch(qnames, queries)
        assert res.fallback_rows > 0
        for i in range(8):
            hc, _ = host.count_overlaps(qnames[i], queries[i])
            assert res.counts[i] == hc

    def test_pacbio_device_counts_match(self, corpus):
        # HPC preset on device: host-sketched 38-bit hash planes,
        # span-aware chain DP with the min_cnt gate
        targets, tnames, queries, qnames = corpus
        params = preset_for(Platform.PACBIO, dual=True)
        index = build_index(targets[:60], tnames[:60], params)
        dev = DeviceOverlapEngine(index, batch_size=8, num_anchors=1024, window=64)
        from lrge_tpu.native import native

        if native is None:
            assert not dev.device_ok
            pytest.skip("native sketcher unavailable")
        assert dev.device_ok and dev.pb_mode
        res = dev.count_batch(qnames[:16], queries[:16])
        host = OverlapEngine(index)
        for i in range(16):
            hc, hh = host.count_overlaps(qnames[i], queries[i])
            assert res.counts[i] == hc, f"query {i}: device {res.counts[i]} host {hc}"
            assert bool(res.had_mapping[i]) == bool(hh)

    def test_pacbio_device_homopolymer_corpus(self):
        # homopolymer-rich genome: HPC compression and variable spans do
        # real work; counts must still match the exact host engine
        rng = np.random.default_rng(97)
        parts = []
        for _ in range(3000):
            base = rng.choice(list(b"ACGT"))
            parts.append(bytes([base]) * int(rng.integers(1, 8)))
        genome = b"".join(parts)
        targets = make_reads(rng, genome, 50, 1800, err=0.05)
        tnames = [f"h{i}".encode() for i in range(50)]
        queries = make_reads(rng, genome, 12, 2000, err=0.05)
        qnames = [f"hq{i}".encode() for i in range(12)]
        params = preset_for(Platform.PACBIO, dual=True)
        index = build_index(targets, tnames, params)
        dev = DeviceOverlapEngine(index, batch_size=8, num_anchors=1024, window=64)
        from lrge_tpu.native import native

        if native is None:
            pytest.skip("native sketcher unavailable")
        res = dev.count_batch(qnames, queries)
        host = OverlapEngine(index)
        for i in range(12):
            hc, _ = host.count_overlaps(qnames[i], queries[i])
            assert res.counts[i] == hc, f"query {i}: device {res.counts[i]} host {hc}"

    def test_packed_planes_match_unpacked(self, corpus, monkeypatch):
        # single-gather posting/dictionary packings (packed_rid_bits /
        # packed_dict_bits) must be a pure layout change: counts equal
        # the unpacked planes bit-for-bit
        targets, tnames, queries, qnames = corpus
        params = preset_for(Platform.NANOPORE, dual=True)
        index = build_index(targets, tnames, params)
        monkeypatch.setenv("LRGE_SHARDS", "1")  # grouped path, not sharded
        dev_packed = DeviceOverlapEngine(
            index, batch_size=16, num_anchors=4096, window=128
        )
        assert dev_packed.gdev.packed_rid_bits > 0
        assert dev_packed.gdev.packed_dict_bits > 0
        res_packed = dev_packed.count_batch(qnames, queries)
        monkeypatch.setenv("LRGE_NO_PACK", "1")
        dev_plain = DeviceOverlapEngine(
            index, batch_size=16, num_anchors=4096, window=128
        )
        assert dev_plain.gdev.packed_rid_bits == 0
        assert dev_plain.gdev.packed_dict_bits == 0
        res_plain = dev_plain.count_batch(qnames, queries)
        assert np.array_equal(res_packed.counts, res_plain.counts)
        assert np.array_equal(res_packed.had_mapping, res_plain.had_mapping)
        # and the grouped path (either packing) must equal the exact host
        # engine (the other ONT tests in this file run the sharded path:
        # the CPU test backend exposes 8 virtual devices)
        host = OverlapEngine(index)
        for i, (nm, sq) in enumerate(zip(qnames, queries)):
            hc, hh = host.count_overlaps(nm, sq)
            assert res_packed.counts[i] == hc
            assert bool(res_packed.had_mapping[i]) == bool(hh)

    def test_sup_vmap_matches_lax_map(self, corpus, monkeypatch):
        # the vmapped super-batch axis (LRGE_SUP_VMAP=1) is a pure
        # scheduling change: counts, mapping flags and ava pair lists
        # must equal the sequential lax.map dispatch bit-for-bit
        targets, tnames, queries, qnames = corpus
        params = preset_for(Platform.NANOPORE, dual=True)
        index = build_index(targets, tnames, params)
        monkeypatch.setenv("LRGE_SHARDS", "1")  # grouped path, not sharded
        monkeypatch.setenv("LRGE_SUP_VMAP", "0")
        dev_map = DeviceOverlapEngine(
            index, batch_size=16, num_anchors=4096, window=128
        )
        assert not dev_map.sup_vmap
        pairs_map = {}
        res_map = dev_map.count_batch(qnames, queries, collect_pairs=pairs_map)
        monkeypatch.setenv("LRGE_SUP_VMAP", "1")
        dev_vmap = DeviceOverlapEngine(
            index, batch_size=16, num_anchors=4096, window=128
        )
        assert dev_vmap.sup_vmap
        pairs_vmap = {}
        res_vmap = dev_vmap.count_batch(qnames, queries, collect_pairs=pairs_vmap)
        assert np.array_equal(res_map.counts, res_vmap.counts)
        assert np.array_equal(res_map.had_mapping, res_vmap.had_mapping)
        assert pairs_map.keys() == pairs_vmap.keys()
        for q in pairs_map:
            assert np.array_equal(np.sort(pairs_map[q]), np.sort(pairs_vmap[q]))

    def test_host_share_split_matches_device_only(self, corpus, monkeypatch):
        # the heterogeneous host+device split is a scheduling decision:
        # counts must equal the device-only run row-for-row, and the
        # share rows must be accounted under their own trigger
        targets, tnames, queries, qnames = corpus
        # enough rows to cross the 4*batch_size activation gate
        qnames = qnames * 3
        queries = queries * 3
        qnames = [b"s%d_" % i + n for i, n in enumerate(qnames)]
        params = preset_for(Platform.NANOPORE, dual=True)
        index = build_index(targets, tnames, params)
        monkeypatch.setenv("LRGE_SHARDS", "1")
        monkeypatch.setenv("LRGE_HOST_SHARE", "0")
        dev0 = DeviceOverlapEngine(index, batch_size=16, num_anchors=4096, window=128)
        res0 = dev0.count_batch(qnames, queries)
        monkeypatch.setenv("LRGE_HOST_SHARE", "0.5")
        dev1 = DeviceOverlapEngine(index, batch_size=16, num_anchors=4096, window=128)
        res1 = dev1.count_batch(qnames, queries)
        assert dev1.fallback_triggers.get("host_share", 0) >= len(queries) // 3
        # host-share rows are scheduled work, not fallback (the count can
        # only shrink: rows that would have window-missed on device may
        # now be share rows)
        assert res1.fallback_rows <= res0.fallback_rows
        assert np.array_equal(res0.counts, res1.counts)
        assert np.array_equal(res0.had_mapping, res1.had_mapping)

    def test_host_share_pairs_match_device_only(self, corpus, monkeypatch):
        # ava's pair collection under the heterogeneous split: share rows
        # get their pair lists from the native kernel and must equal the
        # device-only run
        targets, tnames, queries, qnames = corpus
        qnames = qnames * 3
        queries = queries * 3
        qnames = [b"p%d_" % i + n for i, n in enumerate(qnames)]
        params = preset_for(Platform.NANOPORE, dual=False)
        index = build_index(targets[:60], tnames[:60], params)
        monkeypatch.setenv("LRGE_SHARDS", "1")
        monkeypatch.setenv("LRGE_HOST_SHARE", "0")
        dev0 = DeviceOverlapEngine(index, batch_size=16, num_anchors=4096, window=128)
        p0 = {}
        res0 = dev0.count_batch(qnames, queries, collect_pairs=p0)
        monkeypatch.setenv("LRGE_HOST_SHARE", "0.5")
        dev1 = DeviceOverlapEngine(index, batch_size=16, num_anchors=4096, window=128)
        p1 = {}
        res1 = dev1.count_batch(qnames, queries, collect_pairs=p1)
        assert dev1.fallback_triggers.get("host_share", 0) > 0
        assert np.array_equal(res0.counts, res1.counts)
        assert p0.keys() == p1.keys()
        for q in p0:
            assert np.array_equal(np.sort(p0[q]), np.sort(p1[q])), q

    def test_zero_anchor_rows(self, corpus):
        # rows with no index hits at all: the dynamic DP trip bound is 0
        # for an all-miss batch (the while_loop body never runs) and
        # counts must be 0 / had_mapping False; mixed batches still match
        # the host on the rows that do map
        targets, tnames, queries, qnames = corpus
        params = preset_for(Platform.NANOPORE, dual=True)
        index = build_index(targets, tnames, params)
        rng = np.random.default_rng(4242)
        alien = [bytes(rng.choice(list(b"ACGT"), size=1500).tolist()) for _ in range(8)]
        anames = [b"alien%d" % i for i in range(8)]
        dev = DeviceOverlapEngine(index, batch_size=8, num_anchors=2048, window=128)
        # all-miss batch
        res = dev.count_batch(anames, alien)
        assert res.counts.sum() == 0 and not res.had_mapping.any()
        # mixed batch
        host = OverlapEngine(index)
        mix_n = anames + qnames[:8]
        mix_s = alien + queries[:8]
        res = dev.count_batch(mix_n, mix_s)
        for i, (nm, sq) in enumerate(zip(mix_n, mix_s)):
            hc, hh = host.count_overlaps(nm, sq)
            assert res.counts[i] == hc
            assert bool(res.had_mapping[i]) == bool(hh)

    def test_host_share_pacbio_matches_device_only(self, corpus, monkeypatch):
        # the heterogeneous split now covers the HPC preset (native
        # backtrack reduce): counts must equal the device-only run
        targets, tnames, queries, qnames = corpus
        from lrge_tpu.native import native

        if native is None:
            pytest.skip("native kernel unavailable")
        qnames = qnames * 3
        queries = queries * 3
        qnames = [b"pb%d_" % i + n for i, n in enumerate(qnames)]
        params = preset_for(Platform.PACBIO, dual=True)
        index = build_index(targets[:60], tnames[:60], params)
        monkeypatch.setenv("LRGE_HOST_SHARE", "0")
        dev0 = DeviceOverlapEngine(index, batch_size=8, num_anchors=1024, window=64)
        res0 = dev0.count_batch(qnames, queries)
        monkeypatch.setenv("LRGE_HOST_SHARE", "0.5")
        dev1 = DeviceOverlapEngine(index, batch_size=8, num_anchors=1024, window=64)
        res1 = dev1.count_batch(qnames, queries)
        assert dev1.fallback_triggers.get("host_share", 0) > 0
        assert np.array_equal(res0.counts, res1.counts)
        assert np.array_equal(res0.had_mapping, res1.had_mapping)


def test_device_filter_contained_matches_host(tmp_path, monkeypatch):
    """-F on device (fused extent tracking + is_internal reduce) must
    reproduce the host engine's filtered estimates exactly, including
    corpora rich in contained/internal overlaps."""
    from lrge_tpu.strategy.twoset import TwoSetStrategy

    monkeypatch.setenv("LRGE_SHARDS", "1")  # single-device fused path
    rng = np.random.default_rng(31)
    genome = bytes(rng.choice(list(b"ACGT"), size=60_000).tolist())
    rc = bytes.maketrans(b"ACGT", b"TGCA")
    g = np.frombuffer(genome, np.uint8)
    bases = np.frombuffer(b"ACGT", np.uint8)
    fq = tmp_path / "reads.fq"
    with open(fq, "wb") as fh:
        for i in range(120):
            # mix of long reads and short contained fragments: shorts
            # map INSIDE longs -> internal overlaps the filter drops
            L = int(rng.integers(350, 700)) if i % 3 else int(rng.integers(1800, 2600))
            pos = int(rng.integers(0, len(genome) - L))
            arr = g[pos : pos + L].copy()
            ne = rng.binomial(L, 0.06)
            arr[rng.integers(0, L, size=ne)] = bases[rng.integers(0, 4, size=ne)]
            s = arr.tobytes()
            if rng.integers(0, 2):
                s = s.translate(rc)[::-1]
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, s, b"I" * L))
    kw = dict(
        target_num_reads=80, query_num_reads=30, seed=7,
        remove_internal=True, max_overhang_ratio=0.2,
    )
    est_dev, nm_dev = TwoSetStrategy(
        fq, tmpdir=tmp_path / "d", engine="device", **kw
    ).generate_estimates()
    est_host, nm_host = TwoSetStrategy(
        fq, tmpdir=tmp_path / "h", engine="host", **kw
    ).generate_estimates()
    assert nm_dev == nm_host
    np.testing.assert_array_equal(np.asarray(est_dev), np.asarray(est_host))


def test_multi_bucket_routing_matches_host(corpus, monkeypatch):
    """Reads straddling several length buckets must partition across
    per-bucket programs (anchor capacity scaled by bucket, ``SUP``
    shrunk to compensate) and still match the host exactly; buckets
    with fewer rows than LRGE_DEVICE_MIN_ROWS must reroute to the host
    (`device_engine.py` bucket partitioning / sparse routing)."""
    targets, tnames, queries, qnames = corpus
    rng = np.random.default_rng(99)
    genome = bytes(rng.choice(list(b"ACGT"), size=120_000).tolist())
    # lengths straddling the 1024 and 2048 boundaries + a long tail
    lens = [700, 900, 1000, 1020, 1100, 1500, 1900, 2040, 600, 800] * 3
    extra = make_reads(rng, genome, len(lens), 2000, err=0.08)
    q2, qn2 = [], []
    for i, L in enumerate(lens):
        q2.append(extra[i][:L])
        qn2.append(b"mb%d" % i)
    # two reads longer than the last bucket -> long_read host fallback
    q2.append(make_reads(rng, genome, 1, 2500, err=0.08)[0])
    qn2.append(b"mblong0")
    params = preset_for(Platform.NANOPORE, dual=True)
    index = build_index(targets, tnames, params)
    host = OverlapEngine(index)
    monkeypatch.setenv("LRGE_DEVICE_BUCKET", "1024,2048")
    monkeypatch.setenv("LRGE_DEVICE_MIN_ROWS", "2")
    dev = DeviceOverlapEngine(index, batch_size=8, num_anchors=2048, window=128)
    res = dev.count_batch(qn2, q2)
    assert dev.fallback_triggers.get("long_read", 0) >= 1
    for i, (nm, sq) in enumerate(zip(qn2, q2)):
        hc, hh = host.count_overlaps(nm, sq)
        assert res.counts[i] == hc, f"row {i} (len {len(sq)})"
        assert bool(res.had_mapping[i]) == bool(hh)


def test_ultralong_reads_stay_on_device(monkeypatch):
    """Reads >16 kb must run on the 32 kb device bucket (VERDICT r4
    item 4: the reference's own fixture holds a 32,437 bp read,
    `alignment.rs:52-68`; minimap2 streams any length with O(w) state,
    `aligner.rs:230-241`) and match the exact host engine."""
    rng = np.random.default_rng(411)
    genome = bytes(rng.choice(list(b"ACGT"), size=300_000).tolist())
    targets = make_reads(rng, genome, 40, 18_000, err=0.10)
    tnames = [b"ul%d" % i for i in range(len(targets))]
    queries = [
        make_reads(rng, genome, 1, L, err=0.10)[0]
        for L in (17_000, 20_000, 24_000, 28_000, 31_000, 32_400, 19_000, 26_000)
    ]
    qnames = [b"uq%d" % i for i in range(len(queries))]
    params = preset_for(Platform.NANOPORE, dual=True)
    index = build_index(targets, tnames, params)
    host = OverlapEngine(index)
    monkeypatch.setenv("LRGE_DEVICE_BUCKET", "16384,32768")
    monkeypatch.setenv("LRGE_HOST_SHARE", "0")
    dev = DeviceOverlapEngine(index, batch_size=8, num_anchors=8192, window=128)
    res = dev.count_batch(qnames, queries)
    # the whole point: ultralong rows dispatch on device, not host
    assert dev.fallback_triggers.get("long_read", 0) == 0
    assert dev.fallback_triggers.get("sparse_bucket", 0) == 0
    assert res.fallback_rows < len(queries)
    for i, (nm, sq) in enumerate(zip(qnames, queries)):
        hc, hh = host.count_overlaps(nm, sq)
        assert res.counts[i] == hc, f"row {i} (len {len(sq)})"
        assert bool(res.had_mapping[i]) == bool(hh)


def test_flatten_matches_lax_map(corpus, monkeypatch):
    """The flattened [SUP*B]-row schedule (default) and the per-slot
    lax.map schedule (LRGE_NO_FLAT=1) must be pure schedule changes:
    identical counts row for row."""
    targets, tnames, queries, qnames = corpus
    params = preset_for(Platform.NANOPORE, dual=True)
    index = build_index(targets, tnames, params)
    monkeypatch.setenv("LRGE_HOST_SHARE", "0")
    dev = DeviceOverlapEngine(index, batch_size=16, num_anchors=4096, window=128)
    assert dev.flatten
    res_flat = dev.count_batch(qnames, queries)
    monkeypatch.setenv("LRGE_NO_FLAT", "1")
    dev2 = DeviceOverlapEngine(index, batch_size=16, num_anchors=4096, window=128)
    assert not dev2.flatten
    res_map = dev2.count_batch(qnames, queries)
    assert np.array_equal(res_flat.counts, res_map.counts)
    assert np.array_equal(res_flat.had_mapping, res_map.had_mapping)


def test_packed_codes_match_unpacked(corpus, monkeypatch):
    """2-bit packed code upload (default) vs raw uint8 upload
    (LRGE_NO_PACKCODES=1) must be a pure transfer-layout change —
    including on reads containing ambiguous bases, which the
    sketch-quirk triage recomputes on host either way."""
    targets, tnames, queries, qnames = corpus
    # inject Ns into a couple of queries to exercise the triage
    q2 = list(queries)
    q2[0] = q2[0][:100] + b"NNNN" + q2[0][104:]
    q2[3] = b"N" * 10 + q2[3][10:]
    params = preset_for(Platform.NANOPORE, dual=True)
    index = build_index(targets, tnames, params)
    monkeypatch.setenv("LRGE_HOST_SHARE", "0")
    dev = DeviceOverlapEngine(index, batch_size=16, num_anchors=4096, window=128)
    res_packed = dev.count_batch(qnames, q2)
    monkeypatch.setenv("LRGE_NO_PACKCODES", "1")
    dev2 = DeviceOverlapEngine(index, batch_size=16, num_anchors=4096, window=128)
    res_raw = dev2.count_batch(qnames, q2)
    assert np.array_equal(res_packed.counts, res_raw.counts)
    host = OverlapEngine(index)
    for i, (nm, sq) in enumerate(zip(qnames, q2)):
        hc, _ = host.count_overlaps(nm, sq)
        assert res_packed.counts[i] == hc, f"row {i}"


def test_filter_gate_rejects_long_targets(monkeypatch):
    """-F chain-start packing is (rpos << 16) | qpos in int32, so the
    device filter must refuse indexes whose targets reach 2^15 bases
    (the shift would overflow and corrupt extents silently); such runs
    take the exact host -F path instead."""
    rng = np.random.default_rng(2024)
    genome = bytes(rng.choice(list(b"ACGT"), size=120_000).tolist())
    targets = make_reads(rng, genome, 12, 2000, err=0.08)
    targets.append(make_reads(rng, genome, 1, 40_000, err=0.08)[0])
    tnames = [b"lt%d" % i for i in range(len(targets))]
    params = preset_for(Platform.NANOPORE, dual=True)
    index = build_index(targets, tnames, params)
    monkeypatch.setenv("LRGE_SHARDS", "1")
    dev = DeviceOverlapEngine(index, batch_size=8, num_anchors=4096, window=128)
    assert not dev.supports_device_filter()
    # a short-target index on the same settings stays device-eligible
    index2 = build_index(targets[:12], tnames[:12], params)
    dev2 = DeviceOverlapEngine(index2, batch_size=8, num_anchors=4096, window=128)
    assert dev2.supports_device_filter()


def test_multi_bucket_sparse_rerouting(corpus, monkeypatch):
    """A bucket holding fewer rows than LRGE_DEVICE_MIN_ROWS must be
    rerouted to the concurrent host path (sparse_bucket trigger)."""
    targets, tnames, queries, qnames = corpus
    params = preset_for(Platform.NANOPORE, dual=True)
    index = build_index(targets, tnames, params)
    host = OverlapEngine(index)
    monkeypatch.setenv("LRGE_DEVICE_BUCKET", "1024,2048")
    monkeypatch.setenv("LRGE_DEVICE_MIN_ROWS", "3")
    monkeypatch.setenv("LRGE_HOST_SHARE", "0")
    # 8 short rows (bucket 1024) + ONE mid row (bucket 2048, sparse)
    q2 = [q[:900] for q in queries[:8]] + [queries[8][:1800]]
    qn2 = [b"sp%d" % i for i in range(9)]
    dev = DeviceOverlapEngine(index, batch_size=8, num_anchors=2048, window=128)
    res = dev.count_batch(qn2, q2)
    assert dev.fallback_triggers.get("sparse_bucket", 0) == 1
    for i, (nm, sq) in enumerate(zip(qn2, q2)):
        hc, _ = host.count_overlaps(nm, sq)
        assert res.counts[i] == hc, f"row {i}"


def _contained_corpus(tmp_path, rng_seed=31, n=120, genome_size=60_000):
    rng = np.random.default_rng(rng_seed)
    genome = bytes(rng.choice(list(b"ACGT"), size=genome_size).tolist())
    rc = bytes.maketrans(b"ACGT", b"TGCA")
    g = np.frombuffer(genome, np.uint8)
    bases = np.frombuffer(b"ACGT", np.uint8)
    fq = tmp_path / "reads.fq"
    with open(fq, "wb") as fh:
        for i in range(n):
            L = int(rng.integers(350, 700)) if i % 3 else int(rng.integers(1800, 2600))
            pos = int(rng.integers(0, len(genome) - L))
            arr = g[pos : pos + L].copy()
            ne = rng.binomial(L, 0.06)
            arr[rng.integers(0, L, size=ne)] = bases[rng.integers(0, 4, size=ne)]
            s = arr.tobytes()
            if rng.integers(0, 2):
                s = s.translate(rc)[::-1]
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, s, b"I" * L))
    return fq


def test_device_ava_filter_matches_host(tmp_path, monkeypatch):
    """ava -F on device: the filtered reduce feeds the pair plane, so
    symmetric counting must match the host's seen-pairs + is_internal
    semantics (`ava.rs:283-301`) on a containment-rich corpus."""
    from lrge_tpu.strategy.ava import AvaStrategy

    monkeypatch.setenv("LRGE_SHARDS", "1")
    fq = _contained_corpus(tmp_path)
    kw = dict(num_reads=90, seed=11, remove_internal=True, max_overhang_ratio=0.2)
    est_dev, nm_dev = AvaStrategy(
        fq, tmpdir=tmp_path / "d", engine="device", **kw
    ).generate_estimates()
    est_host, nm_host = AvaStrategy(
        fq, tmpdir=tmp_path / "h", engine="host", **kw
    ).generate_estimates()
    assert nm_dev == nm_host
    np.testing.assert_array_equal(np.asarray(est_dev), np.asarray(est_host))


def test_device_inverse_filter_matches_host(tmp_path, monkeypatch):
    """--use-min-ref -F on device: the inverted overhang comparison
    (`twoset.rs:493-517`) in the fused reduce + pair accumulation must
    match the host path exactly."""
    from lrge_tpu.strategy.twoset import TwoSetStrategy

    monkeypatch.setenv("LRGE_SHARDS", "1")
    fq = _contained_corpus(tmp_path, rng_seed=47)
    kw = dict(
        target_num_reads=80, query_num_reads=30, seed=13,
        remove_internal=True, max_overhang_ratio=0.2, use_min_ref=True,
    )
    sd = TwoSetStrategy(fq, tmpdir=tmp_path / "d", engine="device", **kw)
    est_dev, nm_dev = sd.generate_estimates()
    assert sd.target_num_bases > sd.query_num_bases, "inverse direction must engage"
    sh = TwoSetStrategy(fq, tmpdir=tmp_path / "h", engine="host", **kw)
    est_host, nm_host = sh.generate_estimates()
    assert nm_dev == nm_host
    np.testing.assert_array_equal(np.asarray(est_dev), np.asarray(est_host))


class TestWindowedProbe:
    """The windowed dictionary probe must match a reference linear probe
    bit-for-bit, including buckets at the very END of the unique-hash
    table where the fetch window clamps to [U-kmax, U)."""

    def test_dict_lookup_matches_linear_probe(self):
        import jax.numpy as jnp

        from lrge_tpu.ops.overlap_jax import _dict_lookup

        rng = np.random.default_rng(0)
        k, bits, kmax = 15, 6, 8
        hash_bits = 2 * k
        nb = 1 << bits
        # uniques sorted by hash; engineered so the LAST bucket holds
        # several keys (window clamp exercised) and one bucket overflows
        # nothing (kmax is the true max occupancy)
        uh = np.sort(
            rng.choice(np.uint32(1 << 30), size=200, replace=False).astype(np.uint64)
        )
        # force a run of keys into the top bucket
        top = (np.uint64(nb - 1) << np.uint64(hash_bits - bits))
        uh[-5:] = top + np.arange(5).astype(np.uint64)
        uh = np.sort(uh)
        ub = (uh >> np.uint64(hash_bits - bits)).astype(np.int64)
        boff = np.zeros(nb + 1, np.int32)
        np.add.at(boff, ub + 1, 1)
        np.cumsum(boff, out=boff)
        uhash_t = (uh.astype(np.uint32) ^ np.uint32(0x80000000)).view(np.int32)

        # queries: every real key (hits, incl. the clamped tail) plus misses
        q = np.concatenate(
            [
                uh.astype(np.uint32),
                rng.choice(1 << 30, 64).astype(np.uint32),
            ]
        )
        rng.shuffle(q)
        q = q.reshape(4, -1)

        got = np.asarray(
            _dict_lookup(
                jnp.asarray(q), jnp.asarray(uhash_t), jnp.asarray(boff),
                k=k, bucket_bits=bits, bucket_kmax=kmax,
            )
        )

        # reference linear probe
        want = np.full(q.shape, -1, np.int32)
        qk = (q ^ np.uint32(0x80000000)).view(np.int32)
        ubq = np.minimum(q >> np.uint32(hash_bits - bits), np.uint32(nb - 1)).astype(int)
        for i in range(q.shape[0]):
            for j in range(q.shape[1]):
                for p in range(boff[ubq[i, j]], boff[ubq[i, j] + 1]):
                    if uhash_t[p] == qk[i, j]:
                        want[i, j] = p
        assert np.array_equal(got, want)


class TestCuckooDictionary:
    """The 2-probe cuckoo dictionary (ops/overlap_jax.py) must place
    every unique key retrievably and yield counts identical to the
    bucketed dictionary and the exact host engine."""

    def test_build_places_every_key(self):
        from lrge_tpu.ops.overlap_jax import _build_cuckoo, _cuckoo_slots

        rng = np.random.default_rng(7)
        keys = np.unique(
            rng.integers(0, 1 << 30, size=100_000, dtype=np.uint32)
        )
        pos, cbits = _build_cuckoo(keys)
        C = 1 << cbits
        # positions unique and within the table
        assert len(np.unique(pos)) == len(keys)
        assert pos.min() >= 0 and pos.max() < C
        # every key sits at one of its two candidate slots
        h1, h2 = _cuckoo_slots(keys, cbits)
        assert np.all((pos == h1) | (pos == h2))

    def test_lookup_matches_table(self):
        import jax.numpy as jnp

        from lrge_tpu.ops.overlap_jax import (
            _build_cuckoo,
            _cuckoo_lookup,
        )

        rng = np.random.default_rng(8)
        keys = np.unique(rng.integers(0, 1 << 30, size=5_000, dtype=np.uint32))
        pos, cbits = _build_cuckoo(keys)
        C = 1 << cbits
        sentinel = np.uint32(1 << 30)
        ckey = np.full(C, sentinel, np.uint32)
        ckey[pos] = keys
        ckey_t = (ckey ^ np.uint32(0x80000000)).view(np.int32)
        # probe every real key (must find its slot) and misses (must be -1)
        misses = rng.integers(0, 1 << 30, size=512, dtype=np.uint32)
        misses = misses[~np.isin(misses, keys)]
        q = np.concatenate([keys, misses])
        want = np.concatenate([pos.astype(np.int64), np.full(len(misses), -1)])
        order = rng.permutation(len(q))
        pad = (-len(q)) % 8
        q = np.concatenate([q[order], np.full(pad, 0xFFFFFFFF, np.uint32)])
        want = np.concatenate([want[order], np.full(pad, -1)])
        got = np.asarray(
            _cuckoo_lookup(
                jnp.asarray(q.reshape(8, -1)),
                jnp.asarray(ckey_t),
                cuckoo_bits=cbits,
            )
        ).reshape(-1)
        # padding lanes (0xFFFFFFFF) transform above the key range: miss
        assert np.array_equal(got, want)

    def test_engine_counts_match_bucketed_and_host(self, corpus, monkeypatch):
        monkeypatch.setenv("LRGE_HOST_SHARE", "0")
        monkeypatch.setenv("LRGE_SHARDS", "1")  # grouped path, not sharded
        targets, tnames, queries, qnames = corpus
        params = preset_for(Platform.NANOPORE, dual=True)
        index = build_index(targets, tnames, params)
        dev = DeviceOverlapEngine(index, batch_size=16, num_anchors=4096, window=128)
        if dev.gdev is None or dev.gdev.cuckoo_bits == 0:
            pytest.skip("corpus layout did not take the cuckoo path")
        res = dev.count_batch(qnames, queries)
        monkeypatch.setenv("LRGE_NO_CUCKOO", "1")
        dev_b = DeviceOverlapEngine(index, batch_size=16, num_anchors=4096, window=128)
        assert dev_b.gdev.cuckoo_bits == 0
        res_b = dev_b.count_batch(qnames, queries)
        np.testing.assert_array_equal(res.counts, res_b.counts)
        host = OverlapEngine(index)
        for i, (nm, sq) in enumerate(zip(qnames, queries)):
            hc, _ = host.count_overlaps(nm, sq)
            assert res.counts[i] == hc


class TestResolveEngine:
    def test_explicit_choices_pass_through(self):
        from lrge_tpu.device_engine import resolve_engine

        assert resolve_engine("host", 10**6) == "host"
        assert resolve_engine("device", 1) == "device"

    def test_auto_is_host_on_cpu_backend(self):
        from lrge_tpu.device_engine import resolve_engine

        # the test backend IS cpu (conftest), so size never matters
        assert resolve_engine("auto", 10**9) == "host"

    def test_auto_thresholds_by_rows_on_accelerator(self, monkeypatch):
        import lrge_tpu.device_engine as de

        class FakeJax:
            @staticmethod
            def default_backend():
                return "gpu"

        import sys

        monkeypatch.setitem(sys.modules, "jax", FakeJax())
        assert de.resolve_engine("auto", 999) == "host"
        assert de.resolve_engine("auto", 1000) == "device"
        monkeypatch.setenv("LRGE_AUTO_MIN_ROWS", "50")
        assert de.resolve_engine("auto", 64) == "device"
