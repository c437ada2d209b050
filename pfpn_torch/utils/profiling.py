"""Tracing helpers: a profiler window and named regions.

Counterpart of ``pfpn_tpu/utils/profiling.py`` over ``torch.profiler``::

    from pfpn_torch.utils.profiling import annotate, trace

    with trace("/tmp/trace"):          # CPU and, on a card, CUDA activity
        state, m = algo.train_round(state)

    with annotate("rollout"):          # a named region in the trace
        ...

``trace`` writes a Chrome trace (``trace.json``, for chrome://tracing or
Perfetto) into ``logdir``. ``annotate`` is a ``record_function`` region
and, on a machine with CUDA, an NVTX range. The JAX package's
``enable_xla_dump`` sets ``XLA_FLAGS`` and has no counterpart without XLA.
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body (CUDA activity too where a card is present) and
    write ``logdir/trace.json``. Yields the profiler, whose
    ``key_averages()`` summarize the window."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named region: ``record_function`` plus an NVTX range on CUDA."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
