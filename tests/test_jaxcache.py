"""Persistent compile-cache placement (utils/jaxcache.py)."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import json, os, jax
from lrge_tpu.utils import jaxcache
jaxcache.enable_cache()
jax.jit(lambda x: x * 3 + 1)(jax.numpy.arange(7)).block_until_ready()
print(json.dumps({"config": jax.config.jax_compilation_cache_dir,
                  "dir": jaxcache.cache_dir(), "stats": jaxcache.cache_stats()}))
"""


def _run_probe(**env):
    e = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    e.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO), **env)
    res = subprocess.run(
        [sys.executable, "-c", _PROBE], env=e, capture_output=True, text=True,
        timeout=300, cwd=REPO,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_enable_cache_honours_jax_env_dir(tmp_path):
    want = str(tmp_path / "jc")
    out = _run_probe(JAX_COMPILATION_CACHE_DIR=want)
    # JAX read the variable itself; the code set no other directory
    assert out["config"] == want
    assert out["dir"] == want
    assert out["stats"]["requests"] >= 1
    assert os.listdir(want), "no cache entry written under the env dir"


def test_default_cache_dir_is_fixed_and_in_checkout():
    a = _run_probe()
    b = _run_probe()
    assert a["dir"] == b["dir"] == a["config"] == b["config"]
    assert Path(a["dir"]).parent == REPO / ".jax_cache"
    # the second process loads what the first compiled
    assert b["stats"]["hits"] == b["stats"]["requests"] >= 1
