"""MACE (higher-order equivariant message passing, arXiv:2206.07697).

Assigned config: 2 layers, 128 channels, l_max = 2, correlation
order 3, 8 radial Bessel functions, E(3)-equivariant ACE features.

Structure per layer (the ACE "density trick"), as the JAX package has
it:

  A_i^{c,lm} = sum_{j in N(i)} R_{c,l}(r_ij) Y_lm(r̂_ij) (W h_j)_c

  B-features: symmetric contractions of A up to correlation order 3:
    nu=1:  A_{c,00}                                 (1 / channel)
    nu=2:  sum_m A_{c,lm}^2  for l = 0, 1, 2         (3 / channel)
    nu=3:  sum G[(l1m1),(l2m2),(l3m3)] A A A  per allowed
           (l1,l2,l3) in {(000),(011),(022),(112),(222)} (5 / channel;
           G = the real Gaunt table, geometry.py)

  h_i' = MLP([h_i, B_i])   (9 invariants per channel)

Node features carry invariant (L = 0) channels between layers (the
"invariant readout" MACE variant of the JAX package).

``A`` is one segment sum a layer over ``edge_dst`` of the (E, C, 9)
messages, an (E, 9 C) table on the kernel route.  The gathers of the
coordinates and of ``W h`` at the edges' ends take their backward on
the same route (``layers.py::gather_rows``): the messages carry the
edge mask, so their gradient is 0 at a masked edge.  The bispectrum is
the product ``A_a A_b`` (N, C, 81) times the (81, 45) reshaped table,
then a product with ``A_c``: no intermediate beyond (N, C, 81), 7.05 GB
a layer at minibatch_lg.  The JAX package's ``einsum("kabc,nxa,nxb,nxc
->nxk")``, contracted left to right as ``torch.einsum`` does without
``opt_einsum``, would hold (5, 9, 9, N, C): 35 GB a layer, kept for the
backward.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.common import fan_in_init
from repro_torch.models.gnn.geometry import (
    LM_INDEX,
    at_least,
    bessel_basis,
    cosine_cutoff,
    real_gaunt_table,
    real_sph_harm_l2,
)
from repro_torch.models.gnn.layers import (
    AGG_IMPLS,
    block_diagonal,
    gather_rows,
    init_mlp,
    mlp_apply,
    node_nll,
    segment_sum,
)


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    d_hidden: int = 128
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    cutoff: float = 5.0
    d_in: int = 10
    n_classes: int = 0
    agg_impl: str = "spmm_ell"  # one of layers.AGG_IMPLS

    def __post_init__(self):
        if self.agg_impl not in AGG_IMPLS:
            raise ValueError(f"agg_impl must be one of {AGG_IMPLS}, got {self.agg_impl!r}")


# allowed (l1, l2, l3) bispectrum combos for l_max = 2 (even parity,
# triangle inequality)
_BIS_COMBOS = [(0, 0, 0), (0, 1, 1), (0, 2, 2), (1, 1, 2), (2, 2, 2)]


def _combo_gaunt() -> np.ndarray:
    """(5, 9, 9, 9) per-combo real-Gaunt tensors."""
    G = real_gaunt_table()
    ls = np.array([l for l, m in LM_INDEX])
    out = np.zeros((len(_BIS_COMBOS),) + G.shape, np.float32)
    for ci, (l1, l2, l3) in enumerate(_BIS_COMBOS):
        mask = (
            (ls[:, None, None] == l1)
            & (ls[None, :, None] == l2)
            & (ls[None, None, :] == l3)
        )
        out[ci] = np.where(mask, G, 0.0)
    return out


def init_params(gen: torch.Generator, cfg: MACEConfig) -> dict:
    """The JAX package's layout: ``layers[i].{w_h, radial, update}`` and
    ``readout``, on ``gen``'s device."""
    C, n_l = cfg.d_hidden, cfg.l_max + 1
    n_inv = 1 + n_l + len(_BIS_COMBOS)  # A00 + power + bispectrum
    layers = []
    for i in range(cfg.n_layers):
        d_in = cfg.d_in if i == 0 else C
        layers.append({
            "w_h": fan_in_init(gen, (d_in, C), d_in),
            # radial MLP: bessel -> per (channel, l) weight
            "radial": init_mlp(gen, [cfg.n_rbf, 32, C * n_l]),
            "update": init_mlp(gen, [C * n_inv + d_in, C, C]),
        })
    out_dim = cfg.n_classes if cfg.n_classes > 0 else 1
    return {"layers": layers, "readout": init_mlp(gen, [C, C, out_dim])}


def bispectrum(A, gaunt) -> torch.Tensor:
    """(N, C, 5) ``sum_abc gaunt[k, a, b, c] A_a A_b A_c`` of A (N, C, 9)
    and the (5, 9, 9, 9) combo table: (A_a A_b) (N, C, 81) times the
    table as (81, 9 x 5), then times A_c and summed over c.  The last
    contraction is elementwise: as a ``bmm`` of N C (1, 9) x (9, 5)
    products it takes cuBLAS one launch per 65,535 of them, half of a
    minibatch_lg step on the card."""
    N, C, L = A.shape
    K = gaunt.shape[0]
    ab = (A[..., :, None] * A[..., None, :]).reshape(N, C, L * L)
    u = (ab @ gaunt.permute(1, 2, 3, 0).reshape(L * L, L * K)).reshape(N, C, L, K)
    return (u * A[..., None]).sum(2)


def forward(params, x, coords, edge_src, edge_dst, edge_mask, cfg: MACEConfig):
    """Returns invariant node features (N, C)."""
    n, C, n_l = x.shape[0], cfg.d_hidden, cfg.l_max + 1
    ew = edge_mask.to(torch.float32)
    vec = (gather_rows(coords, edge_dst, edge_mask, cfg.agg_impl)
           - gather_rows(coords, edge_src, edge_mask, cfg.agg_impl))
    dist = torch.linalg.vector_norm(vec + 1e-12, dim=-1)
    unit = vec / at_least(dist, 1e-9)[:, None]
    Y = real_sph_harm_l2(unit)                      # (E, 9)
    rbf = bessel_basis(dist, cfg.n_rbf, cfg.cutoff) * cosine_cutoff(dist, cfg.cutoff)[:, None]

    ls = torch.tensor([l for l, m in LM_INDEX], device=x.device)  # (9,)
    gaunt = torch.as_tensor(_combo_gaunt(), device=x.device)  # (5, 9, 9, 9)
    l_onehot = (ls[:, None] == torch.arange(n_l, device=x.device)[None, :]).to(torch.float32)

    h = x
    for lp in params["layers"]:
        hm = h @ lp["w_h"]                           # (N, C)
        R = mlp_apply(lp["radial"], rbf).reshape(-1, C, n_l)  # (E, C, n_l)
        R_lm = R.index_select(2, ls)                 # (E, C, 9)
        msg = (gather_rows(hm, edge_src, edge_mask, cfg.agg_impl)[:, :, None] * R_lm
               * Y[:, None, :] * ew[:, None, None])  # (E, C, 9)
        A = segment_sum(msg, edge_dst, edge_mask, n, cfg.agg_impl)  # (N, C, 9)

        # --- symmetric contractions (ACE product basis) ---
        b1 = A[:, :, 0:1]                            # nu=1 (N, C, 1)
        b2 = (A * A) @ l_onehot                      # nu=2 (N, C, n_l), power spectrum
        b3 = bispectrum(A, gaunt)                    # nu=3 (N, C, 5)
        B = torch.cat([b1, b2, b3], dim=-1)          # (N, C, 9)
        h = mlp_apply(lp["update"], torch.cat([B.reshape(n, -1), h], dim=-1))
    return h


def energy(params, x, coords, es, ed, em, cfg: MACEConfig):
    h = forward(params, x, coords, es, ed, em, cfg)
    return torch.sum(mlp_apply(params["readout"], h))


def regression_loss(params, batch, cfg: MACEConfig):
    """Packed molecule batch as one block-diagonal graph (as
    ``egnn.regression_loss``)."""
    flat = block_diagonal(batch)
    h = forward(params, flat["x"], flat["coords"], flat["edge_src"], flat["edge_dst"],
                flat["edge_mask"], cfg)
    # each graph's energy: the sum of its nodes' readout
    e = mlp_apply(params["readout"], h).reshape(batch["x"].shape[0], -1).sum(1)
    return torch.mean((e - batch["y"]) ** 2)


def node_classification_loss(params, batch, cfg: MACEConfig):
    h = forward(params, batch["x"], batch["coords"], batch["edge_src"],
                batch["edge_dst"], batch["edge_mask"], cfg)
    return node_nll(mlp_apply(params["readout"], h), batch["labels"])
