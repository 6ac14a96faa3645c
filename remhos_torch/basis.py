"""1D bases and quadrature for tensor-product DG elements (host numpy).

The port's own copy of the `remhos_tpu.basis` subset that the Cartesian
remap path uses: Bernstein values/gradients for the DG solution space,
Lagrange values/gradients at Gauss-Lobatto (mesh) and Gauss-Legendre (mass
inverse) nodes, Gauss-Legendre quadrature, and the tensor composition with
axis 0 fastest. Plain float64 numpy, run once at setup.
"""

from __future__ import annotations

from functools import lru_cache
from math import comb

import numpy as np


@lru_cache(maxsize=None)
def gauss_legendre(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre rule on [0, 1] (points, weights)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return (0.5 * (x + 1.0)), (0.5 * w)


@lru_cache(maxsize=None)
def gauss_lobatto(n: int) -> np.ndarray:
    """n Gauss-Lobatto-Legendre points on [0, 1] (endpoints included),
    interior points from the eigenvalues of the Jacobi(1,1) matrix."""
    if n == 2:
        return np.array([0.0, 1.0])
    m = n - 2
    k = np.arange(1, m, dtype=np.float64)
    b = np.sqrt(k * (k + 2.0) / ((2.0 * k + 1.0) * (2.0 * k + 3.0)))
    J = np.diag(b, 1) + np.diag(b, -1)
    interior = np.sort(np.linalg.eigvalsh(J))
    pts = np.concatenate([[-1.0], interior, [1.0]])
    return 0.5 * (pts + 1.0)


def min_gauss_points(order: int) -> int:
    """1D Gauss points integrating polynomials of `order` exactly (MFEM's
    IntRules.Get for tensor geometries)."""
    return order // 2 + 1


def bernstein_vals(p: int, x: np.ndarray) -> np.ndarray:
    """Bernstein basis values on [0, 1]; returns [len(x), p+1]."""
    x = np.asarray(x, dtype=np.float64)[:, None]
    i = np.arange(p + 1)[None, :]
    c = np.array([float(comb(p, k)) for k in range(p + 1)])[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        v = c * np.power(x, i) * np.power(1.0 - x, p - i)
    return np.where(np.isnan(v), 0.0, v)


def bernstein_grads(p: int, x: np.ndarray) -> np.ndarray:
    """d/dx of the Bernstein basis; returns [len(x), p+1]."""
    x = np.asarray(x, dtype=np.float64)
    if p == 0:
        return np.zeros((len(x), 1))
    lower = bernstein_vals(p - 1, x)
    g = np.zeros((len(x), p + 1))
    g[:, :-1] -= p * lower
    g[:, 1:] += p * lower
    return g


def lagrange_vals(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Lagrange basis at `nodes`, evaluated at `x`: [len(x), len(nodes)]."""
    nodes = np.asarray(nodes, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    n = len(nodes)
    v = np.ones((len(x), n))
    for i in range(n):
        for j in range(n):
            if i != j:
                v[:, i] *= (x - nodes[j]) / (nodes[i] - nodes[j])
    return v


def lagrange_grads(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """d/dx of the Lagrange basis at `x`: [len(x), len(nodes)]."""
    nodes = np.asarray(nodes, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    n = len(nodes)
    g = np.zeros((len(x), n))
    for i in range(n):
        for k in range(n):
            if k == i:
                continue
            term = np.ones_like(x) / (nodes[i] - nodes[k])
            for j in range(n):
                if j != i and j != k:
                    term *= (x - nodes[j]) / (nodes[i] - nodes[j])
            g[:, i] += term
    return g


def tensor_mixed(tables: list[np.ndarray]) -> np.ndarray:
    """Tensor-compose per-axis tables [nq_a, nb_a] -> [prod nq, prod nb],
    both indices lexicographic with axis 0 fastest."""
    out = tables[0]
    for t in tables[1:]:
        out = np.einsum("qb,rc->rqcb", out, t).reshape(
            out.shape[0] * t.shape[0], out.shape[1] * t.shape[1])
    return out


def tensor_mixed_grads(vals: list[np.ndarray],
                       grads: list[np.ndarray]) -> np.ndarray:
    """Per-axis derivative tables of a mixed tensor basis: [Q, B, dim]."""
    dim = len(vals)
    return np.stack(
        [tensor_mixed([grads[a] if a == d else vals[a] for a in range(dim)])
         for d in range(dim)], axis=-1)
