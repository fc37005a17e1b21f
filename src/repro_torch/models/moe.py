"""Mixture-of-Experts FFN (token-choice top-k), on one card or with
its experts over the tensor-parallel ranks (EP-as-TP).

The port of the JAX package's ``models/moe.py``: on one card its
``_moe_local`` on one device, where every expert is local.  The steps,
each with the reference's semantics:

  route     f32 router logits, softmax, top-k (ties to the lower expert
            index, as ``jax.lax.top_k``), gates renormalised over the k;
            a stable sort of the (token, choice) pairs by expert gives
            each pair its rank within its expert, and a pair is kept
            when that rank is below the capacity C
  dispatch  every pair's row copied into an (E, C, d) buffer, a dropped
            pair's as zeros into one overflow row past it (the
            reference's overflow slot, which the experts never see):
            kept pairs have distinct slots, so this is a copy, and no
            step reads a count back to the host
  experts   SwiGLU per expert by ``torch.bmm``; the gate and up products
            come out in the model dtype, then SwiGLU runs in f32 and
            rounds once (the reference keeps the two products in f32: in
            bf16 this rounds them once more, on the CPU and the card
            alike)
  combine   each token's kept outputs times their gates, summed from +0
            in the model dtype in ascending expert order: the order in
            which the reference's scatter-add applies them.  A gather
            through the sort and a fixed sum, no atomics: the bits repeat.
  aux       the Switch load-balance loss over the pairs before drops

Across ranks (``topo`` of more than one rank) a rank holds experts
[m E/tp, (m+1) E/tp) of tp rank m, each FSDP-split over dp and
all-gathered by the layer before the call, so ``moe_ffn`` is given the
rank's experts whole: one body serves one card (m 0, all E experts) and
a rank.  The tokens come replicated over tp, so every tp
rank routes them alike; the capacity is the rank's token count's (its
B/dp rows, or all B where dp does not divide B: the JAX package's
per-shard capacity, so which pairs drop depends on dp).  A rank keeps
its own experts' pairs of rank below C and combines them as above; one
all_reduce over tp sums the ranks' outputs, and the aux loss is the
mean over dp of each dp rank's.

Training differentiates through the ranks' collectives: the routing
runs alike on every tp rank (its gradients whole there), the tokens and
the gates enter the rank's experts through ``copy_to`` (their gradients,
partial on each rank, summed over tp) and the pairs' sum leaves through
``reduce_from``.  Under the sequence-parallel residual (``seq_shard``)
the input is the rank's S/tp slice, all-gathered over tp first, and the
output is reduce-scattered back to the slice.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import (
    copy_to,
    gather_from,
    reduce_from,
    reduce_scatter_to,
    swiglu,
)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int
    capacity_factor: float = 1.25
    min_capacity: int = 4
    aux_loss_weight: float = 0.01


def capacity(cfg: MoEConfig, n_local_tokens: int) -> int:
    c = int(cfg.capacity_factor * n_local_tokens * cfg.top_k
            / cfg.n_experts)
    return max(cfg.min_capacity, c)


@dataclasses.dataclass
class Route:
    """One routing decision over N tokens, each (N, k) in choice order
    (descending gate): ``idx`` the experts, ``gates`` the renormalised
    f32 gates, ``rank`` each pair's place among its expert's pairs
    (token-major), ``keep`` rank < C; ``probs`` (N, E) f32 and
    ``counts`` (E,) the pairs an expert was given before drops."""
    idx: torch.Tensor
    gates: torch.Tensor
    rank: torch.Tensor
    keep: torch.Tensor
    probs: torch.Tensor
    counts: torch.Tensor

    @property
    def dropped(self) -> int:
        """The (token, choice) pairs past capacity (one host read)."""
        return int((~self.keep).sum())


def route(x, router_w, cfg: MoEConfig, C: int) -> Route:
    """x (N, d) -> the :class:`Route` of its tokens at capacity C."""
    N = x.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
    # a stable descending sort keeps equal probabilities in index order
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top[:, :k], idx[:, :k]
    gates = gates / gates.sum(dim=-1, keepdim=True)
    flat_e = idx.reshape(-1)
    # stable: within an expert, lower token ids first
    order = torch.argsort(flat_e, stable=True)
    # a one-hot sum, not bincount: bincount reads its input's max back
    counts = (flat_e[:, None] == torch.arange(E, device=x.device)).sum(0)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(flat_e)
    rank[order] = torch.arange(N * k, device=x.device) - starts[flat_e[order]]
    rank = rank.reshape(N, k)
    return Route(idx=idx, gates=gates, rank=rank, keep=rank < C,
                 probs=probs, counts=counts)


def moe_ffn(x, router_w, w_gate, w_up, w_down, cfg: MoEConfig, topo=None, *,
            batch_over_dp: bool = False, seq_shard: bool = False):
    """x (B, S, d), router_w (d, E), w_gate/w_up (E, d, f), w_down
    (E, f, d) -> (out (B, S, d), aux f32 scalar).  Across ranks
    (``topo``) x is the rank's tokens (its rows of the batch where
    ``batch_over_dp``, else the whole batch; with ``seq_shard`` its S/tp
    slice of them, and so is out) and the expert weights are its E/tp
    experts, whole (their FSDP blocks gathered)."""
    if topo is not None and seq_shard:
        # every token on every tp rank; the routing's gradients are whole
        # on each, so the backward keeps the rank's slice of them
        x = gather_from(x, topo, 1, "tp", grad_sum=False)
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    El = w_gate.shape[0]  # E, or this rank's E/tp experts
    m = 0 if topo is None else topo.tp_rank
    xl = x.reshape(-1, d)
    N = xl.shape[0]
    C = capacity(cfg, N)
    r = route(xl, router_w, cfg, C)  # alike on every tp rank
    keep, le = r.keep, r.idx
    if El < E:  # the pairs of this rank's experts, by their local index
        le = r.idx - m * El
        keep = keep & (le >= 0) & (le < El)

    # dispatch: kept rows into distinct slots, dropped ones (as zeros)
    # into the overflow row El*C
    slot = torch.where(keep, le * C + r.rank, El * C).reshape(-1)
    xd = copy_to(xl, topo, "tp")  # its gradient: this rank's experts' part
    rows = torch.where(keep.reshape(-1, 1), xd.repeat_interleave(k, dim=0), 0)
    buf = xl.new_zeros((El * C + 1, d))
    buf[slot] = rows
    buf = buf[:El * C].view(El, C, d)

    # experts
    h = swiglu(torch.bmm(buf, w_gate).float(),
               torch.bmm(buf, w_up).float()).to(x.dtype)
    y = torch.bmm(h, w_down).reshape(El * C, d)

    # combine: each token's k slots in ascending expert order, from +0
    order = torch.argsort(r.idx, dim=-1)
    keep_s = torch.gather(keep, 1, order)
    slot_s = torch.where(keep_s, torch.gather(le, 1, order) * C
                         + torch.gather(r.rank, 1, order), 0)
    gate_s = torch.gather(copy_to(r.gates, topo, "tp"), 1, order).to(x.dtype)
    vals = torch.where(keep_s[..., None], y[slot_s], 0)
    out = torch.zeros_like(xl)
    for j in range(k):
        out = out + gate_s[:, j, None] * vals[:, j]

    # Switch load-balance loss over every pair, kept or not
    frac = r.counts.float() / float(N * k)
    aux = float(E) * torch.sum(frac * r.probs.mean(dim=0))
    out = out.reshape(B, S, d)
    if topo is not None:  # the other ranks' experts' pairs
        out = reduce_scatter_to(out, topo, 1, "tp") if seq_shard else reduce_from(out, topo, "tp")
        if batch_over_dp:
            aux = reduce_from(aux, topo, "dp") / topo.dp_size
    return out, aux
