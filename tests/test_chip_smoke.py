"""chip_smoke.py: the parts that run without a GPU."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def test_corpus_is_seeded_and_deterministic(tmp_path, monkeypatch):
    monkeypatch.setattr(chip_smoke, "GENOME_SIZE", 400_000)
    a, b, c = tmp_path / "a.fq", tmp_path / "b.fq", tmp_path / "c.fq"
    chip_smoke.write_corpus(str(a), 40, seed=7)
    chip_smoke.write_corpus(str(b), 40, seed=7)
    chip_smoke.write_corpus(str(c), 40, seed=8)
    assert a.read_bytes() == b.read_bytes()
    assert a.read_bytes() != c.read_bytes()
    lines = a.read_bytes().splitlines()
    assert len(lines) == 4 * 40
    assert all(len(lines[i + 1]) == len(lines[i + 3]) >= 500 for i in range(0, 160, 4))


def test_exits_nonzero_without_gpu():
    env = {k: v for k, v in os.environ.items() if not k.startswith("LRGE_")}
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "no GPU" in res.stderr
