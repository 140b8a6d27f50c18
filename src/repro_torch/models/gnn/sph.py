"""Real spherical harmonics (l <= 2) + Gaunt coupling tensor (port of
``repro/models/gnn/sph.py``).

The equivariant bilinear coupling used by MACE-style models. We use the
*Gaunt* tensor G[a,b,c] = ∫ Y_a Y_b Y_c dΩ as the coupling: it is a valid
(non-zero multiple of the real-basis Clebsch-Gordan) equivariant projector
for every (l1,l2,l3) channel, and each channel carries its own learnable
weight, so the constant is absorbed.

G is computed *exactly* on first use by Gauss-Legendre (cos θ) x trapezoid
(φ) quadrature: products of three l<=2 harmonics are spherical polynomials
of degree <= 6, integrated exactly by 16 GL nodes x 32 φ nodes.

``real_sph_np``, ``gaunt_tensor`` and ``check_orthonormal`` are the
reference's numpy code, so the Gaunt tensor has the reference's bits;
``real_sph`` is the harmonics on tensors.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

# Component order (l, m): index -> l
LS = np.array([0, 1, 1, 1, 2, 2, 2, 2, 2])
N_COMP = 9
L_SLICES = {0: slice(0, 1), 1: slice(1, 4), 2: slice(4, 9)}

_C0 = 0.28209479177387814      # 1/(2 sqrt(pi))
_C1 = 0.4886025119029199       # sqrt(3/(4 pi))
_C2a = 1.0925484305920792      # sqrt(15/(4 pi))
_C2b = 0.31539156525252005     # sqrt(5/(16 pi))
_C2c = 0.5462742152960396      # sqrt(15/(16 pi))


def real_sph_np(u: np.ndarray) -> np.ndarray:
    """u: [..., 3] unit vectors -> [..., 9] real SH values (numpy)."""
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    return np.stack([
        np.full_like(x, _C0),
        _C1 * y, _C1 * z, _C1 * x,
        _C2a * x * y, _C2a * y * z, _C2b * (3 * z * z - 1),
        _C2a * x * z, _C2c * (x * x - y * y),
    ], axis=-1)


def real_sph(u: torch.Tensor) -> torch.Tensor:
    """u: [..., 3] unit vectors -> [..., 9] real SH values (tensors)."""
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    return torch.stack([
        torch.full(x.shape, _C0, dtype=x.dtype, device=x.device),
        _C1 * y, _C1 * z, _C1 * x,
        _C2a * x * y, _C2a * y * z, _C2b * (3 * z * z - 1),
        _C2a * x * z, _C2c * (x * x - y * y),
    ], dim=-1)


@functools.lru_cache(maxsize=1)
def gaunt_tensor() -> np.ndarray:
    """G[a, b, c] = ∫ Y_a Y_b Y_c dΩ, exact quadrature. float32 [9, 9, 9]."""
    nodes, weights = np.polynomial.legendre.leggauss(16)   # cos(theta)
    nphi = 32
    phi = np.arange(nphi) * (2 * np.pi / nphi)
    ct = nodes[:, None]
    st = np.sqrt(np.maximum(0.0, 1 - ct ** 2))
    x = st * np.cos(phi)[None, :]
    y = st * np.sin(phi)[None, :]
    z = np.broadcast_to(ct, x.shape)
    u = np.stack([x, y, z], axis=-1)                       # [16, 32, 3]
    ysh = real_sph_np(u)                                   # [16, 32, 9]
    w = weights[:, None] * (2 * np.pi / nphi)              # [16, 1]
    g = np.einsum("tpa,tpb,tpc,tp->abc", ysh, ysh, ysh,
                  np.broadcast_to(w, x.shape))
    g[np.abs(g) < 1e-12] = 0.0
    return g.astype(np.float32)


def check_orthonormal() -> float:
    """Max deviation of <Y_a Y_b> from identity — sanity for tests."""
    nodes, weights = np.polynomial.legendre.leggauss(16)
    nphi = 32
    phi = np.arange(nphi) * (2 * np.pi / nphi)
    ct = nodes[:, None]
    st = np.sqrt(np.maximum(0.0, 1 - ct ** 2))
    u = np.stack([st * np.cos(phi)[None], st * np.sin(phi)[None],
                  np.broadcast_to(ct, (16, nphi))], axis=-1)
    ysh = real_sph_np(u)
    w = weights[:, None] * (2 * np.pi / nphi)
    gram = np.einsum("tpa,tpb,tp->ab", ysh, ysh,
                     np.broadcast_to(w, (16, nphi)))
    return float(np.abs(gram - np.eye(N_COMP)).max())
