"""Persistent XLA compilation cache.

Every jitted program (the XLA pre-pass around the row kernel, the XLA
path's scans) is serialized to disk keyed by its HLO fingerprint, so later
processes deserialize instead of recompiling.

Location: ``$JAX_COMPILATION_CACHE_DIR`` when it is set — JAX reads that
variable itself and nothing here overrides it — else ``.jax_cache/`` at the
root of the checkout (git-ignored). The path is part of what makes a later
process find the entries, so it is fixed, never a temporary name.

CPU-only processes never persist: XLA's CPU backend stores AOT-compiled
executables whose embedded machine-feature lists (e.g. +prefer-no-scatter)
are checked against the loading host by cpu_aot_loader — mismatches spam
load errors and can SIGILL. CPU compiles finish in seconds, so persistence
buys nothing there. Every CPU consumer in this repo (tests/conftest.py,
tools/*.py, the dry run) sets ``jax.config.jax_platforms = "cpu"`` *before*
importing pngloss_jax.ops, which is what :func:`enable` inspects.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_enabled = False


def _cpu_only() -> bool:
    """True when this process has explicitly pinned JAX to the CPU backend
    (jax.config or JAX_PLATFORMS). Never initializes the backend."""
    try:
        import jax

        plats = jax.config.jax_platforms or os.environ.get("JAX_PLATFORMS", "")
    except Exception:
        return False
    names = [p.strip().lower() for p in str(plats).split(",") if p.strip()]
    return bool(names) and all(n == "cpu" for n in names)


def cache_dir() -> str:
    """The cache directory this process uses (when it persists at all)."""
    return os.environ.get(ENV) or os.path.join(REPO_ROOT, ".jax_cache")


def enable() -> None:
    """Idempotently turn on JAX's persistent compilation cache.

    Safe to call any time before (or after) backend init — the cache
    config is consulted at each compile, not at client creation. Failures
    (read-only filesystem) degrade to no caching, never to an error: the
    cache is an optimization, not a correctness dependency.
    """
    global _enabled
    if _enabled:
        return
    _enabled = True
    if _cpu_only():
        return
    try:
        import jax

        if not os.environ.get(ENV):
            os.makedirs(cache_dir(), exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", cache_dir())
        # default thresholds skip small/fast programs; we want everything —
        # even a 0.5 s compile costs more than a disk read on later runs
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    except Exception:
        pass
