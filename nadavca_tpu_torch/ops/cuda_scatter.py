"""The locus scatter of the SNP step: wrapper and plain version.

  ``index_add_windows``  csrc/scatter.cu  plain: ``index_add_windows_plain``

It replaces no TPU kernel: the JAX package leaves the scatter to XLA
(``nadavca_tpu/call.py``: ``scatter_values`` and ``.at[].add``). Its plain
version is that composition in PyTorch: :func:`scatter_values` (positions,
complement, clip, mask, vote) and three ``index_add_``. The kernel does the
same in one launch, one thread per (read, window position), with no (R·L)
intermediates, no sort of the 4-value rows and no overflow row: an invalid
position adds nothing.

As in ``ops/cuda_dp``: the wrapper checks its arguments, runs the plain
version on CPU tensors, launches the kernel on CUDA tensors or raises, never
falls back, and counts its launches in ``index_add_windows.launches``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import AlignConfig
from ..utils import kernel_build
from .cuda_dp import _check, _on, _stream

_INDEX_DTYPES = (torch.int32, torch.int64)


def scatter_values(
    base_ll: torch.Tensor,      # (R, L, 4) float32 per-read window log-likelihoods
    window_start: torch.Tensor, # (R,) int genome coord of window base 0 (fwd strand)
    window_len: torch.Tensor,   # (R,) int true window lengths
    strand: torch.Tensor,       # (R,) int +1 / -1
    G: int,
    cfg: AlignConfig,
):
    """The single source of truth for the locus scatter semantics.

    Per-read contributions are clipped to ±cfg.snp_ll_clip so a single
    misanchored read cannot dominate a locus, and each read casts at most one
    "vote" per position for a base whose margin over the runner-up exceeds
    cfg.snp_vote_margin (consumed by call_snps' min-alt-votes filter).

    Returns (flat_pos (R·L,) int64 with G as the overflow row, ll (R·L, 4)
    clipped+masked values, n_valid (R·L,) int32, votes_onehot (R·L, 4) int32).
    """
    R, L, _ = base_ll.shape
    dev = base_ll.device
    window_start = window_start.to(torch.int64)
    window_len = window_len.to(torch.int64)
    li = torch.arange(L, dtype=torch.int64, device=dev)[None, :]   # (1, L)
    rev = strand[:, None] < 0                                       # (R, 1)
    # genome position of window base i
    pos_fwd = window_start[:, None] + li
    pos_rev = window_start[:, None] + (window_len[:, None] - 1 - li)
    pos = torch.where(rev, pos_rev, pos_fwd)                        # (R, L)
    valid = (li < window_len[:, None]) & (pos >= 0) & (pos < G)
    pos_safe = torch.where(valid, pos, torch.full_like(pos, G))     # overflow row

    # complement base axis for reverse reads: A C G T -> T G C A, the axis
    # reversed (made on the device: a tensor of indices from the host would be
    # a blocking copy in the middle of the step)
    ll_rev = base_ll.flip(2)
    ll_raw = torch.where(rev[:, :, None], ll_rev, base_ll)
    ll = ll_raw.clamp(-cfg.snp_ll_clip, cfg.snp_ll_clip)
    ll = torch.where(valid[:, :, None], ll, torch.zeros_like(ll))

    # per-read confident votes (on UNclipped deltas): best base beats the
    # runner-up by the margin. argmax returns the first maximum; ref col is 0
    best = torch.argmax(ll_raw, dim=2)                              # (R, L)
    best_v = ll_raw.max(dim=2).values
    second = torch.sort(ll_raw, dim=2).values[:, :, 2]
    confident = (best_v - second >= cfg.snp_vote_margin) & valid
    onehot = torch.nn.functional.one_hot(best, 4).to(torch.int32) \
        * confident[..., None].to(torch.int32)
    return (pos_safe.reshape(-1), ll.reshape(-1, 4),
            valid.reshape(-1).to(torch.int32), onehot.reshape(-1, 4))


def index_add_windows_plain(acc, cov, votes, base_ll, window_start, window_len, strand,
                            cfg: AlignConfig) -> None:
    """:func:`index_add_windows` in plain PyTorch, on any device: the
    overflow row's entries are zeros (``scatter_values`` masks them), so they
    are added to row 0, which leaves it as it was."""
    G = acc.shape[0]
    flat_pos, ll, n_valid, onehot = scatter_values(
        base_ll, window_start, window_len, strand, G, cfg)
    flat_pos = torch.where(flat_pos < G, flat_pos, torch.zeros_like(flat_pos))
    acc.index_add_(0, flat_pos, ll.to(acc.dtype))
    cov.index_add_(0, flat_pos, n_valid.to(cov.dtype))
    if votes is not None:
        votes.index_add_(0, flat_pos, onehot.to(votes.dtype))


def _check_scatter(acc, cov, votes, base_ll, window_start, window_len, strand):
    """Check the arguments; return ``base_ll`` and the three per-read vectors
    made contiguous (a row selection ``[rows]`` may hand over any layout)."""
    if not isinstance(acc, torch.Tensor) or acc.dim() != 2:
        raise ValueError(f"acc: expected a (G, 4) tensor, got {getattr(acc, 'shape', acc)}")
    if not isinstance(base_ll, torch.Tensor) or base_ll.dim() != 3:
        raise ValueError(f"base_ll: expected (R, L, 4), got {getattr(base_ll, 'shape', base_ll)}")
    dev, G = acc.device, acc.shape[0]
    R, L = base_ll.shape[0], base_ll.shape[1]
    _check("acc", acc, torch.float32, (G, 4), dev)
    _check("cov", cov, torch.int32, (G,), dev)
    if votes is not None:
        _check("votes", votes, torch.int32, (G, 4), dev)
    base_ll = base_ll.contiguous()
    _check("base_ll", base_ll, torch.float32, (R, L, 4), dev)
    vecs = []
    for name, t in (("window_start", window_start), ("window_len", window_len),
                    ("strand", strand)):
        if not isinstance(t, torch.Tensor) or t.dtype not in _INDEX_DTYPES:
            raise TypeError(f"{name}: expected an int32 or int64 tensor, got "
                            f"{getattr(t, 'dtype', type(t).__name__)}")
        t = t.contiguous()
        _check(name, t, t.dtype, (R,), dev)
        vecs.append(t)
    if dev.type == "cuda":
        # the kernel moves a position's 4 floats as one 16-byte vector
        for name, t in (("acc", acc), ("base_ll", base_ll)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: must start on a 16-byte boundary")
    return base_ll, vecs


def index_add_windows(acc: torch.Tensor, cov: torch.Tensor, votes: Optional[torch.Tensor],
                      base_ll: torch.Tensor, window_start: torch.Tensor,
                      window_len: torch.Tensor, strand: torch.Tensor,
                      cfg: AlignConfig) -> None:
    """Add one batch of read windows into the genome accumulators, in place.

    acc (G, 4) f32, cov (G,) i32, votes (G, 4) i32 or None; base_ll (R, L, 4)
    f32; window_start, window_len, strand (R,) int32 or int64, all on one
    device. Semantics of :func:`scatter_values`: a position adds its clipped
    values to ``acc``, 1 to ``cov`` and, where the read votes, 1 to
    ``votes[pos, best]``. On a CUDA device the float sums are atomic, so
    ``acc`` can differ in its last bits from run to run; ``cov`` and
    ``votes`` are exact."""
    base_ll, (ws, wl, st) = _check_scatter(acc, cov, votes, base_ll, window_start,
                                           window_len, strand)
    dev = acc.device
    if dev.type == "cpu":
        index_add_windows_plain(acc, cov, votes, base_ll, ws, wl, st, cfg)
        return
    if dev.type != "cuda":
        raise ValueError(f"index_add_windows: no kernel for device {dev}")
    lib = kernel_build.load_library()
    R, L = base_ll.shape[0], base_ll.shape[1]
    is64 = [int(t.dtype == torch.int64) for t in (ws, wl, st)]
    with _on(dev):
        code = lib.nadavca_index_add_windows(
            base_ll.data_ptr(), ws.data_ptr(), wl.data_ptr(), st.data_ptr(), *is64,
            acc.data_ptr(), cov.data_ptr(), None if votes is None else votes.data_ptr(),
            R, L, acc.shape[0], float(cfg.snp_ll_clip), float(cfg.snp_vote_margin),
            _stream(dev))
    kernel_build.check_launch(lib, code, "index_add_windows")
    index_add_windows.launches += 1


index_add_windows.launches = 0

KERNELS = (index_add_windows,)


def reset_launches() -> None:
    index_add_windows.launches = 0
