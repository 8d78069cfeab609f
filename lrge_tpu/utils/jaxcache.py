"""Persistent XLA compilation cache bootstrap.

The JAX persistent cache turns a previously-seen program's compile
into a cache load, across processes.  Call :func:`enable_cache` before
the first jit execution; it is idempotent and safe on any backend.

Where the cache lives:

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself at import,
  and this module sets no other directory;
* otherwise a fixed in-checkout path, ``.jax_cache/<machine tag>``.
  The path is stable across processes (no temporary name, pid or
  time), so a later process finds what an earlier one compiled.  The
  tag namespaces it per machine fingerprint (CPU arch + feature flags):
  XLA:CPU cache entries embed AOT-compiled host code, and loading an
  artifact compiled on a machine with different CPU features trips the
  "machine type used for compilation doesn't match" loader warning
  (and could SIGILL).  The fingerprint is computed WITHOUT touching the
  JAX backend, so calling this before ``jax.distributed.initialize``
  stays safe.

:func:`cache_stats` reports persistent-cache requests/hits observed in
this process (via ``jax.monitoring``), so benchmarks can attribute
warmup time to compiles vs cache loads.
"""

from __future__ import annotations

import os

_BASE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(__file__))), ".jax_cache"
)

_enabled = False
_stats = {"requests": 0, "hits": 0}


def _machine_tag() -> str:
    """Stable per-machine fingerprint.

    Axes that decide AOT artifact compatibility: CPU arch + feature
    flags, the jax/XLA version, and the XLA option set — XLA:CPU bakes
    option-derived pseudo-features (``+prefer-no-scatter`` /
    ``+prefer-no-gather``) into the artifact's target-machine string,
    so two processes on the SAME CPU with different ``XLA_FLAGS`` write
    mutually "cross-machine" artifacts that trip the AOT loader's
    machine-mismatch warning on every load.  The ``v2`` epoch orphans
    entries written before option hashing existed."""
    import hashlib
    import platform as _platform

    parts = ["v2", _platform.machine() or "unknown"]
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                # x86 "flags", arm64 "Features": the AOT compatibility axis
                if line.startswith(("flags", "Features")):
                    parts.append(hashlib.sha1(line.encode()).hexdigest()[:10])
                    break
    except OSError:
        pass
    try:
        import jax

        ver = jax.__version__
    except Exception:
        ver = "nojax"
    # normalize to the EFFECTIVE flag mapping (XLA treats repeated
    # flags as last-wins) so semantically identical XLA_FLAGS differing
    # in order/whitespace share a namespace, while orderings of
    # DUPLICATE flags that change the effective value stay distinct;
    # the empty set normalizes to "" (same tag as unset)
    eff = {}
    for tok in os.environ.get("XLA_FLAGS", "").split():
        key = tok.split("=", 1)[0]
        eff[key] = tok
    opt = " ".join(v for _, v in sorted(eff.items()))
    parts.append(
        hashlib.sha1(f"{ver}|{opt}".encode()).hexdigest()[:10]
    )
    return "-".join(parts)


def _listener(event: str, **kwargs) -> None:
    if event == "/jax/compilation_cache/compile_requests_use_cache":
        _stats["requests"] += 1
    elif event == "/jax/compilation_cache/cache_hits":
        _stats["hits"] += 1


def cache_stats() -> dict:
    """{"requests": N, "hits": N} persistent-cache counters (this process)."""
    return dict(_stats)


def cache_dir() -> str:
    """The persistent cache's directory: ``JAX_COMPILATION_CACHE_DIR``
    when set, else ``.jax_cache/<machine tag>`` in the checkout."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _BASE_DIR, _machine_tag()
    )


def enable_cache() -> None:
    global _enabled
    if _enabled:
        return
    import jax
    from jax import monitoring

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        path = cache_dir()
        try:
            os.makedirs(path, exist_ok=True)
        except OSError:  # read-only checkout: run without the cache
            return
        jax.config.update("jax_compilation_cache_dir", path)
    # cache every program: the small ones are loaded per length bucket
    # too, and the hit counters should cover the whole warmup
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    monitoring.register_event_listener(_listener)
    _enabled = True
