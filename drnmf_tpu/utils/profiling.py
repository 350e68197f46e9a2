"""Tracing & profiling: per-stage wall-clock, real-time factor, XLA traces.

The reference's observability was MATLAB tic/toc around the MU loop
(sparse_nmf_gpu.m:207,299) and Keras progress bars.  This module provides the
replacement promised in SURVEY.md §5:

* ``StageTimer`` -- hierarchical named wall-clock stages with a printable
  report and JSON export; the north-star *real-time factor* (seconds of audio
  processed per second of compute) is a first-class aggregate.
* ``trace`` -- context manager around ``jax.profiler`` traces (TensorBoard /
  Perfetto-viewable) gated so it is a no-op when profiling is off.
* ``device_sync`` -- block until all dispatched device work completes, so
  timers measure compute rather than dispatch.
* ``enable_compile_cache`` -- JAX's persistent compilation cache at one
  fixed path, unless ``JAX_COMPILATION_CACHE_DIR`` already names one.
"""

import contextlib
import json
import os
import time

import jax


def device_sync():
    """Block until outstanding device computations finish (all devices --
    a dummy-op flush only covers the default device)."""
    for arr in jax.live_arrays():
        arr.block_until_ready()
    (jax.device_put(0.0) + 0).block_until_ready()


class StageTimer:
    """Named wall-clock stages with real-time-factor accounting.

    Usage::

        timer = StageTimer()
        with timer.stage("featurize", audio_seconds=123.4):
            ...
        print(timer.report())
    """

    def __init__(self):
        self.stages = []  # (name, seconds, audio_seconds)

    @contextlib.contextmanager
    def stage(self, name, audio_seconds=None, sync=False):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            if sync:
                device_sync()
            self.stages.append((name, time.perf_counter() - t0, audio_seconds))

    def total_seconds(self):
        return sum(s for _, s, _ in self.stages)

    def realtime_factor(self):
        """Total audio seconds / total compute seconds over RTF stages."""
        audio = sum(a for _, _, a in self.stages if a)
        compute = sum(s for _, s, a in self.stages if a)
        return (audio / compute) if compute > 0 else float("inf")

    def report(self):
        lines = []
        for name, secs, audio in self.stages:
            rtf = f"  ({audio / secs:.1f}x real-time)" if audio else ""
            lines.append(f"  {name}: {secs:.3f}s{rtf}")
        lines.append(f"  total: {self.total_seconds():.3f}s")
        audio = sum(a for _, _, a in self.stages if a)
        if audio:
            lines.append(
                f"  real-time factor: {self.realtime_factor():.1f}x "
                f"({audio:.1f}s audio)"
            )
        return "\n".join(lines)

    def to_json(self):
        rtf = self.realtime_factor()
        return json.dumps({
            "stages": [
                {"name": n, "seconds": s, "audio_seconds": a}
                for n, s, a in self.stages
            ],
            "total_seconds": self.total_seconds(),
            # None instead of float('inf'): json.dumps would emit the
            # non-standard literal Infinity
            "realtime_factor": rtf if rtf != float("inf") else None,
        })


@contextlib.contextmanager
def trace(log_dir=None):
    """``jax.profiler`` trace context; no-op when ``log_dir`` is None.

    View with TensorBoard (profile plugin) or Perfetto.
    """
    if log_dir is None:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


# one fixed directory inside the checkout: the cache is keyed by path, so a
# directory that moved between runs would never hit
_CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def default_compile_cache_dir():
    """The persistent compilation cache directory the program sets when
    the caller names none: None when ``JAX_COMPILATION_CACHE_DIR`` is set
    (JAX reads that variable itself), else ``<checkout>/.jax_cache``."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return _CHECKOUT_CACHE_DIR


def enable_compile_cache(cache_dir=None):
    """Enable JAX's persistent compilation cache in ``cache_dir``, or where
    :func:`default_compile_cache_dir` says.

    min_compile_time_secs is 0: a CLI run compiles many small programs
    (one per featurization, prediction and scoring bucket), each under
    JAX's default one-second threshold, and a rerun would pay all of them
    again.  Returns True on success."""
    if cache_dir is None:
        cache_dir = default_compile_cache_dir()
    try:
        if cache_dir is not None:
            jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
        return True
    except Exception as e:  # misconfiguration should be visible, not fatal
        import sys

        print(f"warning: compilation cache disabled ({e})", file=sys.stderr)
        return False
