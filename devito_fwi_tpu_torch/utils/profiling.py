"""Profiling helpers; the port's counterpart of
``devito_fwi_tpu.utils.profiling`` (same names, and ``span``) over
``torch.profiler`` and the card's clock.

    with profiling.trace("trace_dir"):
        elastic_fwi_obj_multi(...)      # writes trace_dir/trace.json

    with profiling.timed("gradient"):
        fwi_obj_multi(...)              # prints "gradient: 0.1234 s"

    with profiling.span("fwi.forward"):
        ...                             # an annotation in any active trace
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "timed", "span"]


_OFF = contextlib.nullcontext()


def span(name):
    """The block as a ``torch.profiler`` annotation ``name`` while a
    profiler records, so the trace holds it on the host thread beside the
    kernels and copies it launched; otherwise one shared no-op context.
    The profiler being on is the only switch: with none, a span costs the
    check (an annotation built regardless would cost some 20 times as
    much)."""
    if torch.autograd._profiler_enabled():
        return torch.autograd.profiler.record_function(name)
    return _OFF


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir="devito_fwi_tpu_torch_trace"):
    """Profile a block with ``torch.profiler`` (the host, and the card when
    one is in use) and write a Chrome trace, ``<logdir>/trace.json``
    (chrome://tracing or Perfetto). Yields the profiler, whose
    ``key_averages()`` tabulates the calls."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def timed(label, sink=print):
    """Wall-clock a block; the card, when one is in use, is synchronised
    before each reading of the clock, so the time covers the block's
    device work. ``sink`` receives the line ``"<label>: <seconds> s"``."""
    _sync()
    tic = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        sink("%s: %.4f s" % (label, time.perf_counter() - tic))
