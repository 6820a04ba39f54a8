"""Async inference helpers (counterpart of
``bonai_tpu/utils/async_utils.py``; reference:
``mmdet/utils/contextmanagers.py:16-90``).

``concurrent`` bounds the calls in flight with a semaphore, as the JAX
package does.  ``completed`` waits, at the end of its block, for the work
the block queued on the current CUDA stream: it records an event and polls
it, yielding to the event loop between polls, so other tasks run while the
card works.  Without a card it yields to the loop once, as the JAX
package's does.
"""

from __future__ import annotations

import asyncio
import contextlib

import torch


@contextlib.asynccontextmanager
async def concurrent(limiter):
    """Bound in-flight async inference (reference ``concurrent``,
    ``contextmanagers.py:59-90``); ``limiter`` is an
    ``asyncio.Semaphore``."""
    await limiter.acquire()
    try:
        yield
    finally:
        limiter.release()


@contextlib.asynccontextmanager
async def completed(trace_name="", name="", **kwargs):
    """Await the completion of the block's work on the current CUDA stream
    (reference ``completed``, ``contextmanagers.py:16-57``) without
    blocking the event loop: poll an event recorded after the block,
    yielding to the loop between polls."""
    try:
        yield
    finally:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream())
            while not done.query():
                await asyncio.sleep(0)
        else:
            await asyncio.sleep(0)
