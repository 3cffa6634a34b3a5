"""Page-locked host arrays, and the copies that put a batch on a device.

Where CUDA is present, ``pipeline.assemble_batch`` (and the bands of
``sched.bands.build_chunked_bands``) allocate the arrays a batch uploads
through :func:`host_full`: each is a numpy view of a page-locked (pinned)
torch tensor, which the view holds as its ``base``, so consumers see the
same ndarrays as before and the tensor lives as long as they do.

:class:`Upload` makes one batch's (or row block's) copies to one device. On
a CUDA device every array goes from page-locked memory with a
``non_blocking`` copy on the device's copy stream, made once: the page-locked
tensor under a view is copied itself, so that PyTorch's host allocator
records the copy's event and does not hand the block out again while the
copy is in flight; an array in pageable memory is first copied into a
page-locked block of that allocator (which also recycles such blocks only
once their copies have finished). The destinations are allocated while the
copy stream is current, then ``record_stream``-ed on the caller's stream,
and on leaving the context the caller's stream waits for the copies. So the
host returns at once and everything the caller enqueues later runs after the
copies; a caller that stages batch i+1 before it waits for step i (the CLI's
staging thread) has those copies run on the copy engine while step i runs.
On any other device an array takes the blocking
``torch.from_numpy(a).to(device)`` of before.

``utils.metrics.PROCESS`` counts the bytes handed to the copies,
``upload_bytes``, and of those the bytes handed to ``non_blocking`` copies
from page-locked memory, ``upload_async_bytes``.
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, Optional

import numpy as np
import torch

from .metrics import PROCESS as METRICS

# one copy stream a CUDA device for the process, like the device's default
# stream (``copy_stream``); the lock: the CLI stages on a thread of its own
_STREAMS: Dict[int, "torch.cuda.Stream"] = {}
_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def host_full(shape, fill, dtype) -> np.ndarray:
    """``np.full(shape, fill, dtype)``; page-locked where CUDA is present."""
    dtype = np.dtype(dtype)
    if not torch.cuda.is_available():
        return np.zeros(shape, dtype) if fill == 0 else np.full(shape, fill, dtype)
    t = torch.empty(shape, dtype=_torch_dtype(dtype), pin_memory=True)
    t.fill_(fill)
    return t.numpy()


def host_copy(a: np.ndarray, dtype) -> np.ndarray:
    """``a.astype(dtype)``; page-locked where CUDA is present."""
    if not torch.cuda.is_available():
        return a.astype(dtype)
    out = torch.empty(a.shape, dtype=_torch_dtype(np.dtype(dtype)),
                      pin_memory=True).numpy()
    out[...] = a
    return out


def tensor_under(a: np.ndarray) -> Optional[torch.Tensor]:
    """The view, as a torch tensor of the same storage, of the torch tensor
    whose memory the ndarray ``a`` lies in (found through numpy's ``base``
    chain); None where ``a`` is no view of a torch tensor of its dtype."""
    base = a.base
    while isinstance(base, np.ndarray):
        base = base.base
    if not isinstance(base, torch.Tensor) or base.dtype != _torch_dtype(a.dtype):
        return None
    off = a.__array_interface__["data"][0] - base.data_ptr()
    return base.as_strided(a.shape, [s // a.itemsize for s in a.strides],
                           base.storage_offset() + off // a.itemsize)


def copy_stream(device: torch.device) -> "torch.cuda.Stream":
    """The copy stream of a CUDA device, made at its first use."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    with _LOCK:
        s = _STREAMS.get(idx)
        if s is None:
            s = _STREAMS[idx] = torch.cuda.Stream(device=idx)
    return s


class Upload:
    """The copies of one batch's arrays to ``device``, as a context (module
    docstring): ``with Upload(dev) as up: t = up.put(a)``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.bytes = 0
        self.async_bytes = 0
        self.stream = copy_stream(self.device) if self.device.type == "cuda" else None

    def __enter__(self) -> "Upload":
        if self.stream is not None:
            self.caller = torch.cuda.current_stream(self.device)
            self._ctx = torch.cuda.stream(self.stream)
            self._ctx.__enter__()
        return self

    def put(self, a: np.ndarray) -> torch.Tensor:
        """``a`` on the device (C-contiguous)."""
        a = np.ascontiguousarray(a)
        self.bytes += a.nbytes
        if self.stream is None:
            return torch.from_numpy(a).to(self.device)
        src = tensor_under(a)
        if src is None or not src.is_pinned():
            src = torch.from_numpy(a).pin_memory()
        dst = src.to(self.device, non_blocking=True)
        dst.record_stream(self.caller)
        self.async_bytes += a.nbytes
        return dst

    def __exit__(self, *exc) -> None:
        if self.stream is not None:
            self._ctx.__exit__(*exc)
            self.caller.wait_stream(self.stream)
        METRICS.count("upload_bytes", self.bytes)
        METRICS.count("upload_async_bytes", self.async_bytes)
