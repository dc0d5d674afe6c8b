"""Device-trace profiling — the jax profiler as the tracing backend.

The reference's tracing is the BL_TIMER macro system (timer.hpp); the analog
for *device-side* attribution is the XLA profiler.  `trace()` wraps
a region and writes a TensorBoard-loadable trace; `annotate()` names a
sub-region so kernels group under it.
"""

from __future__ import annotations

import contextlib

import jax

__all__ = ["trace", "annotate"]


@contextlib.contextmanager
def trace(logdir: str = "chiprun_out/trace"):
    """Capture a device trace for the enclosed region (default directory
    relative to the working directory, git-ignored at the repo root).

    View with: tensorboard --logdir <logdir>  (or xprof).
    """
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named sub-region (TraceAnnotation) for kernel grouping."""
    return jax.profiler.TraceAnnotation(name)
