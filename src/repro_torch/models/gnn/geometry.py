"""Geometric bases for the equivariant and molecular GNNs, as the JAX
package's ``models/gnn/geometry.py`` defines them.

* Bessel radial basis (DimeNet eq. 7) and cosine cutoff.
* Real spherical harmonics, closed form for l <= 2 (MACE's l_max 2).
* The real Gaunt table  G[(l1,m1),(l2,m2),(l3,m3)] = integral of
  Y_{l1m1} Y_{l2m2} Y_{l3m3} over the sphere, by a Gauss-Legendre x
  uniform-phi product quadrature (the integrand is band-limited, so the
  quadrature is exact up to rounding).  It is numpy, the reference's
  own bytes: 83 nonzeros of 9 x 9 x 9.

The clamps are ``torch.maximum``/``torch.minimum``, not ``torch.clamp``:
at a tie they split the gradient in halves, as ``jnp.maximum`` and
``jnp.clip`` do (``clamp`` passes all of it).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

# (l, m) index layout for l <= 2: 1 + 3 + 5 = 9 components
LM_INDEX = [(l, m) for l in range(3) for m in range(-l, l + 1)]
N_LM = len(LM_INDEX)


def at_least(x, lo: float):
    return torch.maximum(x, torch.tensor(lo, dtype=x.dtype, device=x.device))


def at_most(x, hi: float):
    return torch.minimum(x, torch.tensor(hi, dtype=x.dtype, device=x.device))


def bessel_basis(r, n_rbf: int, cutoff: float) -> torch.Tensor:
    """DimeNet radial Bessel basis, shape (..., n_rbf)."""
    r = at_least(r, 1e-9)[..., None]
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    return math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * r / cutoff) / r


def cosine_cutoff(r, cutoff: float) -> torch.Tensor:
    u = at_most(at_least(r / cutoff, 0.0), 1.0)
    return 0.5 * (torch.cos(math.pi * u) + 1.0)


def real_sph_harm_l2(unit_vec) -> torch.Tensor:
    """Real spherical harmonics Y_lm(r̂) for l <= 2: unit_vec (..., 3)
    -> (..., 9) in LM_INDEX order."""
    x, y, z = unit_vec[..., 0], unit_vec[..., 1], unit_vec[..., 2]
    c00 = 0.5 * math.sqrt(1.0 / math.pi)
    c1 = math.sqrt(3.0 / (4.0 * math.pi))
    c2_2 = 0.5 * math.sqrt(15.0 / math.pi)
    c2_1 = 0.5 * math.sqrt(15.0 / math.pi)
    c20 = 0.25 * math.sqrt(5.0 / math.pi)
    return torch.stack(
        [
            torch.full_like(x, c00),         # (0, 0)
            c1 * y,                          # (1,-1)
            c1 * z,                          # (1, 0)
            c1 * x,                          # (1, 1)
            c2_2 * x * y,                    # (2,-2)
            c2_1 * y * z,                    # (2,-1)
            c20 * (3 * z * z - 1.0),         # (2, 0)
            c2_1 * x * z,                    # (2, 1)
            0.5 * c2_2 * (x * x - y * y),    # (2, 2)
        ],
        dim=-1,
    )


def _real_sph_harm_np(theta, phi):
    """Numpy version on a (theta, phi) grid, (..., 9)."""
    st, ct = np.sin(theta), np.cos(theta)
    x = st * np.cos(phi)
    y = st * np.sin(phi)
    z = ct
    c00 = 0.5 * math.sqrt(1.0 / math.pi)
    c1 = math.sqrt(3.0 / (4.0 * math.pi))
    c2_2 = 0.5 * math.sqrt(15.0 / math.pi)
    c20 = 0.25 * math.sqrt(5.0 / math.pi)
    return np.stack(
        [
            np.full_like(x, c00),
            c1 * y, c1 * z, c1 * x,
            c2_2 * x * y, c2_2 * y * z,
            c20 * (3 * z * z - 1.0),
            c2_2 * x * z, 0.5 * c2_2 * (x * x - y * y),
        ],
        axis=-1,
    )


@functools.lru_cache(maxsize=None)
def real_gaunt_table() -> np.ndarray:
    """(9, 9, 9) table of the integral of Y_a Y_b Y_c over real SH,
    l <= 2.  Gauss-Legendre (16 points in cos theta) x uniform (32
    points in phi): exact for the degree <= 6 band-limited integrand."""
    xs, ws = np.polynomial.legendre.leggauss(16)
    theta = np.arccos(xs)                      # (16,)
    phi = np.linspace(0, 2 * np.pi, 32, endpoint=False)  # (32,)
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    Y = _real_sph_harm_np(th, ph)              # (16, 32, 9)
    w = ws[:, None] * (2 * np.pi / 32)         # (16, 1)
    G = np.einsum("tpa,tpb,tpc,tp->abc", Y, Y, Y,
                  np.broadcast_to(w, th.shape))
    G[np.abs(G) < 1e-12] = 0.0
    return G.astype(np.float32)
