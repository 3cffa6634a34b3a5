"""Profiling hooks: a ``torch.profiler`` trace behind a context manager and
the CLI's ``--profile`` flag, plus wall-clock stage timers that feed
``utils.metrics``.

Counterpart of ``nadavca_tpu/utils/profiling.py``, whose ``trace`` runs
``jax.profiler``; here the trace is a chrome trace (viewable in Perfetto)
written to ``<dir>/trace.json``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional


@contextlib.contextmanager
def trace(trace_dir: Optional[str]):
    """``torch.profiler`` trace (host and, where there is a card, device
    activity) of the enclosed block when ``trace_dir`` is set."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


class StageTimer:
    """Accumulates wall-clock per named stage; reports into a Metrics object."""

    def __init__(self, metrics=None):
        self.totals = {}
        self.metrics = metrics

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            if self.metrics is not None:
                self.metrics.gauge(f"stage_{name}_s", self.totals[name])
