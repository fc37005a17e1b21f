"""DimeNet (directional message passing, arXiv:2003.03123).

Edge-based messages m_ji with *triplet* interactions: the update of
message m_ji aggregates, over incoming edges k -> j, the source message
m_kj modulated by a radial x angular basis of (d_kj, angle(kj, ji)) and
a bilinear layer.

Assigned config: 6 blocks, d_hidden 128, n_bilinear 8, n_spherical 7,
n_radial 6.  As in the JAX package, the 2D spherical-Bessel basis
j_l(z_ln r) is the separable bessel(n_radial) x Legendre_l(cos alpha)
product.

Each block has two segment sums (``layers.py::segment_sum``, on
``DimeNetConfig.agg_impl``'s route): the triplets' (T, d) contributions
into their edges over ``tri_ji``, and the edges' (E, d) outputs into
their nodes over ``edge_dst``.  With ``msg_dtype="bfloat16"`` the
kernel route upcasts the messages exactly, sums in f32 and casts back:
more precise than the reference's bf16 ``segment_sum``.  The gathers of
h at the edges' ends, of the edge vectors, distances and messages at
the triplets' edges take their backward on the same route
(``layers.py::gather_rows``): the embedding carries the edge mask, the
angular basis and the triplets' contributions the triplet mask, so
their gradient is 0 at a masked row.  The coordinates' gathers keep
``index_select`` on both routes: a live triplet may name a masked edge
(a padded batch's masked edges 0 -> 0 are in-edges of node 0, and
``build_triplets`` pairs them as the reference's does), so the edge
vectors' gradient need not be 0 at a masked edge.  The JAX
package's owner-aligned sharded sum (``scatter_sum_owner_aligned``) is
the plain segment sum on one device.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import fan_in_init
from repro_torch.models.gnn.geometry import at_least, at_most, bessel_basis, cosine_cutoff
from repro_torch.models.gnn.layers import (
    AGG_IMPLS,
    block_diagonal,
    gather_rows,
    init_mlp,
    mlp_apply,
    node_nll,
    segment_sum,
)

MSG_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    d_in: int = 10           # species one-hot
    n_classes: int = 0       # 0 -> regression readout
    # message and edge tensors in bf16 on the web-scale cells; bases and
    # the readout stay f32
    msg_dtype: str = "float32"
    agg_impl: str = "spmm_ell"  # one of layers.AGG_IMPLS

    def __post_init__(self):
        if self.agg_impl not in AGG_IMPLS:
            raise ValueError(f"agg_impl must be one of {AGG_IMPLS}, got {self.agg_impl!r}")
        if self.msg_dtype not in MSG_DTYPES:
            raise ValueError(f"msg_dtype must be one of {sorted(MSG_DTYPES)}, "
                             f"got {self.msg_dtype!r}")


def _legendre(cos_a, n: int) -> torch.Tensor:
    """P_0..P_{n-1}(cos alpha) by the recurrence, stacked (..., n)."""
    p0 = torch.ones_like(cos_a)
    if n == 1:
        return p0[..., None]
    ps = [p0, cos_a]
    for l in range(2, n):
        ps.append(((2 * l - 1) * cos_a * ps[-1] - (l - 1) * ps[-2]) / l)
    return torch.stack(ps[:n], dim=-1)


def init_params(gen: torch.Generator, cfg: DimeNetConfig) -> dict:
    """The JAX package's layout: ``blocks[i].{w_rbf, w_sbf, w_kj,
    bilinear, mlp_update, out_atom}``, ``embed_atom``, ``embed_edge`` and
    ``readout``, on ``gen``'s device."""
    d, nb = cfg.d_hidden, cfg.n_bilinear
    n_sbf = cfg.n_radial * cfg.n_spherical
    blocks = [{
        "w_rbf": fan_in_init(gen, (cfg.n_radial, d), cfg.n_radial),
        "w_sbf": fan_in_init(gen, (n_sbf, nb), n_sbf),
        "w_kj": init_mlp(gen, [d, d]),
        "bilinear": fan_in_init(gen, (nb, d, d), d),
        "mlp_update": init_mlp(gen, [d, d, d]),
        "out_atom": init_mlp(gen, [d, d]),
    } for _ in range(cfg.n_blocks)]
    return {
        "blocks": blocks,
        "embed_atom": init_mlp(gen, [cfg.d_in, d]),
        "embed_edge": init_mlp(gen, [2 * d + cfg.n_radial, d]),
        "readout": init_mlp(gen, [d, d, cfg.n_classes if cfg.n_classes > 0 else 1]),
    }


def _f32_mlp(p, x, final_act: bool = False):
    # the JAX package's bf16 messages meet f32 weights, and jnp promotes
    # the product to f32
    return mlp_apply(p, x.to(torch.float32), final_act=final_act)


def forward(params, x, coords, edge_src, edge_dst, edge_mask,
            tri_kj, tri_ji, tri_mask, cfg: DimeNetConfig):
    """Returns per-node features (N, d) f32 (the sum of every block's
    output)."""
    n = x.shape[0]
    ew = edge_mask.to(torch.float32)[:, None]
    tw = tri_mask.to(torch.float32)[:, None]

    # ---- edge geometry + radial basis ----
    vec = coords.index_select(0, edge_dst) - coords.index_select(0, edge_src)
    dist = torch.linalg.vector_norm(vec + 1e-12, dim=-1)
    rbf = bessel_basis(dist, cfg.n_radial, cfg.cutoff) * cosine_cutoff(dist, cfg.cutoff)[:, None]

    def kj(t):
        return gather_rows(t, tri_kj, tri_mask, cfg.agg_impl)

    # ---- triplet geometry + angular basis ----
    v_kj, v_ji = kj(vec), gather_rows(vec, tri_ji, tri_mask, cfg.agg_impl)
    cos_a = torch.sum(-v_kj * v_ji, dim=-1) / (
        torch.linalg.vector_norm(v_kj + 1e-12, dim=-1)
        * torch.linalg.vector_norm(v_ji + 1e-12, dim=-1))
    d_kj = kj(dist)
    sbf = (bessel_basis(d_kj, cfg.n_radial, cfg.cutoff)[:, :, None]
           * _legendre(at_most(at_least(cos_a, -1.0), 1.0), cfg.n_spherical)[:, None, :]
           ).reshape(tri_kj.shape[0], -1) * tw  # (T, n_radial * n_spherical)

    # ---- embedding block ----
    mdt = MSG_DTYPES[cfg.msg_dtype]
    h = mlp_apply(params["embed_atom"], x, final_act=True)
    m = (mlp_apply(params["embed_edge"],
                   torch.cat([gather_rows(h, edge_src, edge_mask, cfg.agg_impl),
                              gather_rows(h, edge_dst, edge_mask, cfg.agg_impl), rbf], -1),
                   final_act=True) * ew).to(mdt)  # (E, d) messages
    sbf, tw, ew = sbf.to(mdt), tw.to(mdt), ew.to(mdt)

    # ---- interaction blocks (triplet gather + bilinear) ----
    node_out = torch.zeros((n, cfg.d_hidden), dtype=torch.float32, device=x.device)
    E, T, nb, d = m.shape[0], tri_kj.shape[0], cfg.n_bilinear, cfg.d_hidden
    for bp in params["blocks"]:
        m_kj = kj(_f32_mlp(bp["w_kj"], m, final_act=True).to(mdt))
        s = sbf @ bp["w_sbf"].to(mdt)               # (T, nb)
        # einsum("tb,td,bdf->tf") accumulated in f32: the (T, nb d) outer
        # product times the bilinear tensor as (nb d, d)
        outer = (s.to(torch.float32)[:, :, None] * m_kj.to(torch.float32)[:, None, :])
        contrib = (outer.reshape(T, nb * d)
                   @ bp["bilinear"].to(mdt).to(torch.float32).reshape(nb * d, d)).to(mdt)
        agg = segment_sum(contrib * tw, tri_ji, tri_mask, E, cfg.agg_impl)  # (E, d)
        gate = (rbf @ bp["w_rbf"]).to(mdt)          # (E, d)
        m = ((m + _f32_mlp(bp["mlp_update"], agg * gate + m)) * ew).to(mdt)
        node_out = node_out + segment_sum(
            (_f32_mlp(bp["out_atom"], m, final_act=True) * ew).to(torch.float32),
            edge_dst, edge_mask, n, cfg.agg_impl)
    return node_out


_TRIPLET_KEYS = ("x", "coords", "edge_src", "edge_dst", "edge_mask",
                 "tri_kj", "tri_ji", "tri_mask")


def energy(params, x, coords, es, ed, em, tk, tj, tm, cfg: DimeNetConfig):
    node = forward(params, x, coords, es, ed, em, tk, tj, tm, cfg)
    return torch.sum(mlp_apply(params["readout"], node))


def regression_loss(params, batch, cfg: DimeNetConfig):
    """Packed molecule batch as one block-diagonal graph (as
    ``egnn.regression_loss``); graph b's triplets name edges, so they
    shift by b e."""
    flat = block_diagonal(batch)
    node = forward(params, *(flat[k] for k in _TRIPLET_KEYS), cfg)
    # each graph's energy: the sum of its nodes' readout
    e = mlp_apply(params["readout"], node).reshape(batch["x"].shape[0], -1).sum(1)
    return torch.mean((e - batch["y"]) ** 2)


def node_classification_loss(params, batch, cfg: DimeNetConfig):
    node = forward(params, *(batch[k] for k in _TRIPLET_KEYS), cfg)
    return node_nll(mlp_apply(params["readout"], node), batch["labels"])
