"""Profiling hooks: a ``torch.profiler`` trace behind a context manager and
the CLI's ``--profile`` flag, and the program's named spans.

Counterpart of ``nadavca_tpu/utils/profiling.py``, whose ``trace`` runs
``jax.profiler``; here the trace is a chrome trace (viewable in Perfetto)
written to ``<dir>/trace.json``.

A span (:func:`span`) is a ``torch.profiler.record_function`` range, so it
lies on the profiler's own timeline, the one the card's activity (kernels,
copies, memsets) is put on: a device operation can be traced to the span
whose host code launched it, and an idle gap of the card to the span the
host was in. Span names start with ``nadavca.``. With no profiler running a
span costs one flag check (torch's ``_is_profiler_enabled``), not the
microseconds of a ``record_function``. No span synchronises the device or
reads a device tensor.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

# the one context every span returns while no profiler runs
_OFF = contextlib.nullcontext()


def profiler_on() -> bool:
    """Whether a ``torch.profiler`` is recording in this process."""
    return torch.autograd.profiler._is_profiler_enabled


def span(name: str):
    """A named range of host time on the profiler's timeline, as a context
    manager; a shared no-op while no profiler runs."""
    if profiler_on():
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def trace(trace_dir: Optional[str]):
    """``torch.profiler`` trace (host and, where there is a card, device
    activity) of the enclosed block when ``trace_dir`` is set. Every thread
    is recorded: the CLI prepares and uploads batches on a worker thread."""
    if not trace_dir:
        yield
        return
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities,
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
