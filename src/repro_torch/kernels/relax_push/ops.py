"""Public ops: the push-mode frontier gather, and the push relaxation it
feeds (gather, then a torch scatter-min, as in the JAX package's
``relax_push/ops.py``), for one lane and for S lanes in one launch.  A
CUDA tensor launches the kernel; a CPU tensor takes the plain torch
version.  Each gather call is counted by route
(``kernels/_lib.py::kernel_call``)."""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.relax_push.kernel import (
    relax_push_gather_batch_cuda,
    relax_push_gather_cuda,
)
from repro_torch.kernels.relax_push.ref import (
    relax_push_gather_batch_ref,
    relax_push_gather_ref,
)
from repro_torch.kernels.superstep_fused.ref import lane_rows


def relax_push_gather(dist, row_idx, count, row_src, col,
                      wgt) -> torch.Tensor:
    """(F, W) f32 candidates of the listed rows; +inf past ``count``."""
    cpu = dist.device.type == "cpu"
    with _lib.kernel_call("relax_push_gather", "ref" if cpu else "cuda",
                          lanes=1, rows=row_idx.shape[-1], width=wgt.shape[-1],
                          n_local=dist.shape[-1] - 1):
        if cpu:
            return relax_push_gather_ref(dist, row_idx, count, row_src, wgt)
        return relax_push_gather_cuda(dist, row_idx, count, row_src, col, wgt)


def relax_push_rows(dist, row_idx, count, row_src, col, wgt,
                    n_out: int) -> torch.Tensor:
    """(n_out+1,) f32: the gathered candidates scatter-min'd over +inf
    through the listed rows' columns (fill rows take column n_out)."""
    R = col.shape[0]
    cand = relax_push_gather(dist, row_idx, count, row_src, col, wgt)
    F = cand.shape[0]
    colg = torch.index_select(col, 0, row_idx.clamp(0, R - 1))
    colg = torch.where((row_idx < R)[:, None], colg, n_out)
    # a +inf candidate (ELL padding, a row past count, a fill row) is the
    # min's identity: those of row f go to a spill column of their own,
    # n_out + 1 + f, dropped after (the spill columns of core/frontier.py)
    spill = torch.arange(n_out + 1, n_out + 1 + F, device=dist.device)[:, None]
    idx = torch.where(cand != float("inf"), colg, spill)
    out = torch.full((n_out + 1 + F,), float("inf"), dtype=torch.float32,
                     device=dist.device)
    out.scatter_reduce_(0, idx.reshape(-1), cand.reshape(-1), "amin")
    return out[: n_out + 1]


def relax_push_gather_batch(dist, row_idx, count, row_src, col,
                            wgt) -> torch.Tensor:
    """(S, F, W) f32: lane s's candidates of its listed rows of rank
    s % P; +inf past ``count[s]``."""
    cpu = dist.device.type == "cpu"
    with _lib.kernel_call("relax_push_gather_batch", "ref" if cpu else "cuda",
                          lanes=row_idx.shape[0], rows=row_idx.shape[-1],
                          width=wgt.shape[-1], n_local=dist.shape[-1] - 1):
        if cpu:
            return relax_push_gather_batch_ref(dist, row_idx, count, row_src,
                                               wgt)
        return relax_push_gather_batch_cuda(dist, row_idx, count, row_src,
                                            col, wgt)


def relax_push_rows_batch(dist, row_idx, count, row_src, col, wgt,
                          n_out: int) -> torch.Tensor:
    """(S, n_out+1) f32: :func:`relax_push_rows` of every lane, lane s
    over rank s % P, from one launch of the batched gather."""
    cand = relax_push_gather_batch(dist, row_idx, count, row_src, col, wgt)
    S, F = row_idx.shape
    q, r = lane_rows(row_idx, col.shape[0], col.shape[1])
    colg = torch.where((row_idx < col.shape[1])[..., None], col[q, r], n_out)
    # spill columns as in relax_push_rows, n_out + 1 + f for row f
    spill = torch.arange(n_out + 1, n_out + 1 + F, device=dist.device)[:, None]
    idx = torch.where(cand != float("inf"), colg, spill)
    out = torch.full((S, n_out + 1 + F), float("inf"), dtype=torch.float32,
                     device=dist.device)
    out.scatter_reduce_(1, idx.reshape(S, -1), cand.reshape(S, -1), "amin")
    return out[:, : n_out + 1]
