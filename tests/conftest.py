"""Test configuration: force a virtual 8-device CPU mesh.

The suite runs on the CPU backend (``JAX_PLATFORMS=cpu``), with
multi-device sharding validated on 8 virtual CPU devices.  Set
``LRGE_TEST_GPU=1`` to leave the backend to JAX instead and run the
suite on a real GPU (single-device tests only).  The device path is
checked on the GPU end to end by ``chip_smoke.py``.
"""

import os

# tests use small read sets on purpose; keep them on the device path
# instead of the sparse-bucket host routing (a production optimisation)
os.environ.setdefault("LRGE_DEVICE_MIN_ROWS", "0")

if not os.environ.get("LRGE_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")


import time as _time

_SESSION_T0 = _time.time()


def pytest_sessionfinish(session, exitstatus):
    """LRGE_TEST_ARTIFACT=<path>: write an auditable run summary
    (pass/fail counts, duration, collected) so headline test claims in
    VERDICT/round notes have a committed artifact behind them."""
    path = os.environ.get("LRGE_TEST_ARTIFACT")
    if not path:
        return
    import json
    import time

    tr = session.config.pluginmanager.get_plugin("terminalreporter")
    stats = {k: len(v) for k, v in tr.stats.items() if k}
    dur = time.time() - _SESSION_T0
    with open(path, "w") as fh:
        json.dump(
            {
                "exitstatus": int(exitstatus),
                "collected": int(session.testscollected),
                "stats": stats,
                "duration_s": round(dur, 1),
            },
            fh,
            indent=1,
        )
        fh.write("\n")
