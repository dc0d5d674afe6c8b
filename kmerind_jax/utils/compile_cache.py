"""Persistent XLA compilation cache.

The reference compiles one binary per index configuration offline (the
CMake type matrix of BenchmarkKmerIndex,
/root/reference/test/benchmark/BenchmarkKmerIndex.cpp:45-260), so a user
never waits on a compiler at run time.  This framework jit-compiles at
first use instead, and the fused ingest/merge programs are multi-second
compiles.  JAX's persistent compilation cache gives the same
compile-once-per-config economics: every jitted step (ingest, merge,
query, ...) is keyed by (program, shapes, backend) and reloaded from disk
by later processes.

Enabled on ``import kmerind_jax``.  Where ``JAX_COMPILATION_CACHE_DIR`` is
set, JAX reads it itself and this module sets no other directory;
otherwise the cache lives at ``.jax_cache/`` in the checkout — a fixed
path, because the directory is part of what makes later runs hit.
"""

from __future__ import annotations

import os
import pathlib

__all__ = ["cache_dir", "enable"]

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir(environ=os.environ) -> str:
    """The cache directory: ``$JAX_COMPILATION_CACHE_DIR`` when set, else
    ``.jax_cache/`` at the root of the checkout."""
    return environ.get(ENV_VAR) or str(DEFAULT_DIR)


def enable() -> str | None:
    """Turn on JAX's persistent compilation cache; returns its directory,
    or None on CPU-only runs.

    Entries of every size and compile time are cached: the LSM build's
    step programs are exactly the multi-second compiles the cache exists
    for, and even the small glue jits are worth the few kB each.
    """
    # CPU runs (the tests' virtual mesh, the driver dryrun) skip the
    # cache: XLA:CPU AOT deserialization logs a machine-feature-mismatch
    # warning per load, and CPU compiles are seconds
    if "cpu" in os.environ.get("JAX_PLATFORMS", "").lower():
        return None
    import jax
    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # default min compile time is 1s: below-threshold programs would
    # re-compile every cold start; cache everything instead
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
