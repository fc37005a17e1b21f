"""Mixture-of-Experts FFN (token-choice top-k) on one card.

The port of the JAX package's ``models/moe.py`` with no tensor and no
data parallelism: its ``_moe_local`` on one device, where every expert
is local.  The steps, each with the reference's semantics:

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
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import swiglu


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


def moe_ffn(x, router_w, w_gate, w_up, w_down, cfg: MoEConfig):
    """x (B, S, d), router_w (d, E), w_gate/w_up (E, d, f), w_down
    (E, f, d) -> (out (B, S, d), aux f32 scalar)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    xl = x.reshape(-1, d)
    N = xl.shape[0]
    C = capacity(cfg, N)
    r = route(xl, router_w, cfg, C)

    # dispatch: kept rows into distinct slots, dropped ones (as zeros)
    # into the overflow row E*C
    slot = torch.where(r.keep, r.idx * C + r.rank, E * C).reshape(-1)
    rows = torch.where(r.keep.reshape(-1, 1), xl.repeat_interleave(k, dim=0), 0)
    buf = xl.new_zeros((E * C + 1, d))
    buf[slot] = rows
    buf = buf[:E * C].view(E, C, d)

    # experts
    h = swiglu(torch.bmm(buf, w_gate).float(),
               torch.bmm(buf, w_up).float()).to(x.dtype)
    y = torch.bmm(h, w_down).reshape(E * C, d)

    # combine: each token's k slots in ascending expert order, from +0
    order = torch.argsort(r.idx, dim=-1)
    e_s = torch.gather(r.idx, 1, order)
    keep_s = torch.gather(r.keep, 1, order)
    slot_s = torch.where(keep_s, e_s * C + torch.gather(r.rank, 1, order), 0)
    gate_s = torch.gather(r.gates, 1, order).to(x.dtype)
    vals = torch.where(keep_s[..., None], y[slot_s], 0)
    out = torch.zeros_like(xl)
    for j in range(k):
        out = out + gate_s[:, j, None] * vals[:, j]

    # Switch load-balance loss over every pair, kept or not
    frac = r.counts.float() / float(N * k)
    aux = float(E) * torch.sum(frac * r.probs.mean(dim=0))
    return out.reshape(B, S, d), aux
