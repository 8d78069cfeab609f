"""End-to-end estimation tests on synthetic genomes."""

import numpy as np
import pytest

from lrge_tpu import AvaBuilder, TwoSetBuilder

RC = bytes.maketrans(b"ACGT", b"TGCA")
GENOME_SIZE = 200_000
READ_LEN = 2_000
N_READS = 400


@pytest.fixture(scope="module")
def reads_file(tmp_path_factory):
    rng = np.random.default_rng(1234)
    genome = bytes(rng.choice(list(b"ACGT"), size=GENOME_SIZE).tolist())
    path = tmp_path_factory.mktemp("e2e") / "reads.fq"
    with open(path, "wb") as fh:
        for i in range(N_READS):
            pos = int(rng.integers(0, GENOME_SIZE - READ_LEN))
            seq = genome[pos : pos + READ_LEN]
            if rng.integers(0, 2):
                seq = seq.translate(RC)[::-1]
            fh.write(b"@read%d\n%s\n+\n%s\n" % (i, seq, b"I" * len(seq)))
    return path


class TestTwoSet:
    def test_estimate_close_to_genome_size(self, reads_file, tmp_path):
        strat = (
            TwoSetBuilder()
            .target_num_reads(300)
            .query_num_reads(60)
            .seed(42)
            .tmpdir(tmp_path)
            .build(reads_file)
        )
        res = strat.estimate(finite=True)
        assert res.estimate is not None
        # sampling noise with 60 queries is sizable; the point is the
        # pipeline recovers the right order of magnitude and then some
        assert 0.6 * GENOME_SIZE < res.estimate < 1.6 * GENOME_SIZE
        assert res.lower < res.estimate < res.upper

    def test_seeded_determinism(self, reads_file, tmp_path):
        kw = dict(finite=True)
        r1 = (
            TwoSetBuilder()
            .target_num_reads(100)
            .query_num_reads(30)
            .seed(7)
            .tmpdir(tmp_path / "a")
            .build(reads_file)
            .estimate(**kw)
        )
        r2 = (
            TwoSetBuilder()
            .target_num_reads(100)
            .query_num_reads(30)
            .seed(7)
            .tmpdir(tmp_path / "b")
            .build(reads_file)
            .estimate(**kw)
        )
        assert r1.estimate == r2.estimate
        assert r1.lower == r2.lower and r1.upper == r2.upper

    def test_artifacts_written(self, reads_file, tmp_path):
        strat = (
            TwoSetBuilder()
            .target_num_reads(100)
            .query_num_reads(30)
            .seed(7)
            .tmpdir(tmp_path)
            .build(reads_file)
        )
        strat.estimate(finite=True)
        assert (tmp_path / "target.fa").exists()
        assert (tmp_path / "query.fa").exists()
        assert (tmp_path / "overlaps.paf").exists()
        # PAF lines parse back
        from lrge_tpu.paf import PafRecord

        lines = (tmp_path / "overlaps.paf").read_text().splitlines()
        assert len(lines) > 10
        rec = PafRecord.from_line(lines[0])
        assert rec.s1 >= 100

    def test_use_min_ref(self, reads_file, tmp_path):
        # smaller query set becomes the index; estimates still sane
        strat = (
            TwoSetBuilder()
            .target_num_reads(300)
            .query_num_reads(60)
            .use_min_ref(True)
            .seed(42)
            .tmpdir(tmp_path)
            .build(reads_file)
        )
        res = strat.estimate(finite=True)
        assert 0.5 * GENOME_SIZE < res.estimate < 1.8 * GENOME_SIZE

    def test_too_few_reads(self, reads_file, tmp_path):
        from lrge_tpu.errors import TooFewReadsError

        with pytest.raises(TooFewReadsError):
            (
                TwoSetBuilder()
                .target_num_reads(10)
                .query_num_reads(N_READS + 1)
                .tmpdir(tmp_path)
                .build(reads_file)
                .estimate()
            )

    def test_target_shrink_warning(self, reads_file, tmp_path):
        strat = (
            TwoSetBuilder()
            .target_num_reads(N_READS)  # T+Q > N triggers shrink
            .query_num_reads(50)
            .seed(1)
            .tmpdir(tmp_path)
            .build(reads_file)
        )
        res = strat.estimate(finite=True)
        assert strat.target_num_reads == N_READS - 50
        assert res.estimate is not None


class TestAva:
    def test_estimate_close_to_genome_size(self, reads_file, tmp_path):
        strat = (
            AvaBuilder().num_reads(250).seed(42).tmpdir(tmp_path).build(reads_file)
        )
        res = strat.estimate(finite=True)
        assert res.estimate is not None
        assert 0.6 * GENOME_SIZE < res.estimate < 1.6 * GENOME_SIZE

    def test_symmetric_counting(self, reads_file, tmp_path):
        # the per-read estimate vector length equals the subsample size
        strat = (
            AvaBuilder().num_reads(100).seed(3).tmpdir(tmp_path).build(reads_file)
        )
        estimates, no_map = strat.generate_estimates()
        assert len(estimates) == 100


class TestDeviceEngineStrategies:
    @pytest.fixture(autouse=True)
    def _small_device_programs(self, monkeypatch):
        # On the 8-virtual-CPU mesh the default (GPU-sized) program
        # shapes make the sharded warmup step minutes-long and can
        # outlive the collective rendezvous timeout; the integration
        # semantics are shape-independent (same knobs as
        # __graft_entry__.dryrun_multichip).
        monkeypatch.setenv("LRGE_DEVICE_BATCH", "16")
        monkeypatch.setenv("LRGE_DEVICE_ANCHORS", "1024")
        monkeypatch.setenv("LRGE_DEVICE_SUPER", "2")
        monkeypatch.setenv("LRGE_DEVICE_BUCKET", "2048")

    def test_twoset_device_matches_host(self, reads_file, tmp_path):
        host = (
            TwoSetBuilder()
            .target_num_reads(150)
            .query_num_reads(40)
            .seed(11)
            .tmpdir(tmp_path / "h")
            .build(reads_file)
            .estimate(finite=True)
        )
        dev = (
            TwoSetBuilder()
            .target_num_reads(150)
            .query_num_reads(40)
            .seed(11)
            .engine("device")
            .tmpdir(tmp_path / "d")
            .build(reads_file)
            .estimate(finite=True)
        )
        assert dev.estimate == host.estimate
        assert dev.lower == host.lower and dev.upper == host.upper
        assert dev.no_mapping_count == host.no_mapping_count

    def test_ava_device_matches_host(self, reads_file, tmp_path):
        host = (
            AvaBuilder()
            .num_reads(120)
            .seed(11)
            .tmpdir(tmp_path / "ha")
            .build(reads_file)
            .estimate(finite=True)
        )
        dev = (
            AvaBuilder()
            .num_reads(120)
            .seed(11)
            .engine("device")
            .tmpdir(tmp_path / "da")
            .build(reads_file)
            .estimate(finite=True)
        )
        assert dev.estimate == host.estimate
        assert dev.no_mapping_count == host.no_mapping_count


def test_twoset_threads_match_serial(reads_file, tmp_path):
    # forked-worker mapping must not change results
    serial = (
        TwoSetBuilder()
        .target_num_reads(120)
        .query_num_reads(40)
        .seed(5)
        .threads(1)
        .tmpdir(tmp_path / "s")
        .build(reads_file)
        .estimate(finite=True)
    )
    pooled = (
        TwoSetBuilder()
        .target_num_reads(120)
        .query_num_reads(40)
        .seed(5)
        .threads(2)
        .tmpdir(tmp_path / "p")
        .build(reads_file)
        .estimate(finite=True)
    )
    assert pooled.estimate == serial.estimate
    assert pooled.no_mapping_count == serial.no_mapping_count
