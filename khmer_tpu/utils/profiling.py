"""Profiling/tracing hooks (aux subsystem; the reference has only
progress reporting + Makefile gcov hooks — SURVEY.md §5.1 — so the
framework adds JAX profiler traces instead).

Two entry points:

- ``trace(logdir)`` — context manager capturing a JAX profiler trace
  (viewable in TensorBoard / Perfetto) around any region.
- env-gated auto-trace: set ``KHMER_TPU_TRACE=/path/to/logdir`` and
  every CLI script's main consume loop is traced without code changes
  (wired through ``maybe_trace``).

Named regions inside traces use ``annotate`` (a TraceAnnotation), so
device ops show up grouped per pipeline stage.
"""

import contextlib
import os

TRACE_ENV = "KHMER_TPU_TRACE"


@contextlib.contextmanager
def trace(logdir):
    """Capture a JAX profiler trace of the enclosed region."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


_active = [False]


@contextlib.contextmanager
def maybe_trace(region_name="khmer-tpu"):
    """Trace the region iff $KHMER_TPU_TRACE is set (to the logdir).

    Re-entrant: nested maybe_trace regions inside an active trace only
    add a TraceAnnotation (the profiler cannot be started twice)."""
    logdir = os.environ.get(TRACE_ENV)
    if not logdir:
        yield None
        return
    if _active[0]:
        with annotate(region_name):
            yield logdir
        return
    _active[0] = True
    try:
        with trace(logdir), annotate(region_name):
            yield logdir
    finally:
        _active[0] = False


def annotate(name):
    """Named sub-region within a trace (jax.profiler.TraceAnnotation)."""
    import jax

    return jax.profiler.TraceAnnotation(name)


def device_memory_stats():
    """Per-device memory stats dict (HBM usage), when the backend
    exposes them; {} otherwise."""
    import jax

    stats = {}
    for dev in jax.devices():
        try:
            stats[str(dev)] = dev.memory_stats()
        except Exception:
            pass
    return stats
