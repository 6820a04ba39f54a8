"""Profiling helpers (counterpart of ``bonai_tpu/utils/profiling.py``;
reference: ``mmdet/utils/profiling.py:9-40``).

``profile_time`` and ``timed`` take wall time around work that they end
with ``torch.cuda.synchronize()`` on the card, so the device's work is
inside the time; ``device_trace`` records a ``torch.profiler`` trace (the
card's kernels where there is one) and writes it as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import os.path as osp
import time

import torch


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def profile_time(trace_name, name, enabled=True, stream=None,
                 end_stream=None):
    """Print the elapsed wall time of the block, the card's work
    included, as ``'<trace_name> <name> elapsed_time: <ms> ms'``.  Yields
    a dict whose ``'ms'`` holds the time once the block has ended
    (``stream`` and ``end_stream``, mmdet's, are not read)."""
    result = {}
    if not enabled:
        yield result
        return
    _sync()
    t0 = time.perf_counter()
    yield result
    _sync()
    result["ms"] = (time.perf_counter() - t0) * 1000
    print(f"{trace_name} {name} elapsed_time: {result['ms']:.2f} ms")


@contextlib.contextmanager
def device_trace(logdir):
    """Record a ``torch.profiler`` trace of the block (host and, where
    there is a card, its kernels) and write it to
    ``<logdir>/trace.json``, viewable in Perfetto or ``chrome://tracing``.
    Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(osp.join(logdir, "trace.json"))


def timed(fn, *args, iters=10, warmup=2, **kwargs):
    """Steady-state seconds a call of ``fn`` takes, each call ended by a
    synchronisation with the card."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
        _sync()
    return (time.perf_counter() - t0) / iters
