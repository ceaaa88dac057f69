"""Lightweight timing/tracing helpers.

The reference instruments its hot paths with ad-hoc ``time.time()`` prints
behind ``verbose`` flags (tsc.py:167-202, GRAND_HOD.py:1470-1501) and
read-rate reports (pipe_asdf.py:156-163). Here the device-side equivalents
are a wall-clock stage timer that synchronizes the device (so stages are
attributable under async dispatch) and an opt-in ``jax.profiler`` trace
context for real op-level device profiles.
"""

import logging
import time
from contextlib import contextmanager

__all__ = ['stage_timer', 'device_trace', 'Timings']


class Timings(dict):
    """Accumulated {stage: seconds}; pretty string via str()."""

    def __str__(self):
        total = sum(self.values())
        parts = [f'{k}: {v:.4g}s' for k, v in self.items()]
        return ', '.join(parts) + f' (total {total:.4g}s)'


@contextmanager
def stage_timer(name, timings=None, logger=None, sync=True):
    """Time a pipeline stage, synchronizing outstanding device work first
    and at exit so the interval is attributable to this stage.

    >>> t = Timings()
    >>> with stage_timer('paint', t): grid = paint(...)
    """
    if sync:
        _block_on_devices()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            _block_on_devices()
        dt = time.perf_counter() - t0
        if timings is not None:
            timings[name] = timings.get(name, 0.0) + dt
        (logger or logging.getLogger('abacusutils_tpu')).debug(
            '%s: %.4f s', name, dt
        )


def _block_on_devices():
    try:
        import jax

        for d in jax.live_arrays():
            d.block_until_ready()
    except Exception:  # profiling must never break the pipeline
        pass


@contextmanager
def device_trace(logdir='/tmp/abacusutils_tpu_trace'):
    """Capture a jax.profiler trace (viewable with TensorBoard or Perfetto)
    around a block:

    >>> with device_trace('/tmp/trace'): run_step()
    """
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
