"""Root-directory lookup: for each block's sorted partition minima and one
range [lo, hi], the first and last partition the range can touch.

The port of the JAX package's ``kernels/index_search.py``.  The fused
reader (``hail_reader``) does this lookup inline, so no path of the system
calls it; ``ops.index_search`` is its entry point.  The CUDA kernel
(``csrc/index_search.cu``) gives each block row one warp, which counts with
ballots.  It keeps the port's lower-bound rule (``ref.index_search``:
p_first counts the minima below lo).  (lo, hi) travel as a device int32
pair, so one kernel variant serves every range.

``index_search`` routes by device: a CPU tensor takes the plain version
(``index_search_plain``, the ``ref.py`` counterpart), a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

index_search_plain = ref.index_search

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 3 + [_I] * 2 + [_P]


def lohi_pair(lo, hi, device) -> torch.Tensor:
    """(lo, hi) as a (2,) int32 tensor on ``device``: two Python ints are
    copied there in one transfer that does not wait for the device;
    tensors that already live there are stacked without a host sync."""
    if not (torch.is_tensor(lo) or torch.is_tensor(hi)):
        return torch.tensor([lo, hi], dtype=torch.int32).to(
            device, non_blocking=True)
    return torch.stack([torch.as_tensor(x, dtype=torch.int32,
                                        device=device).reshape(())
                        for x in (lo, hi)])


def _check(mins):
    if mins.dtype != torch.int32 or mins.dim() != 2:
        raise ValueError(f"index_search: mins must be 2-d int32, got "
                         f"{mins.dim()}-d {mins.dtype}")
    if not mins.is_contiguous():
        raise ValueError("index_search: mins must be contiguous")


def _launch(mins, lo, hi):
    b, parts = mins.shape
    out = torch.empty((b, 2), dtype=torch.int32, device=mins.device)
    if b == 0:
        return out
    lohi = lohi_pair(lo, hi, mins.device)
    fn = _build.entry("index_search_launch", _ARGTYPES)
    with torch.cuda.device(mins.device):
        stream = torch.cuda.current_stream(mins.device).cuda_stream
        code = fn(mins.data_ptr(), lohi.data_ptr(), out.data_ptr(), b, parts,
                  stream)
    _build.check("index_search", code)
    return out


def index_search(mins: torch.Tensor, lo, hi) -> torch.Tensor:
    """mins (blocks, P) int32, rows sorted; lo, hi ints or 0-d tensors
    -> (blocks, 2) int32 [p_first, p_last]."""
    _check(mins)
    if mins.device.type == "cpu":
        return index_search_plain(mins, lo, hi)
    if mins.device.type != "cuda":
        raise ValueError(f"index_search: no kernel for device {mins.device}")
    return _launch(mins, lo, hi)
