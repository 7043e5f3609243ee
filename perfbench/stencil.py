"""Inputs of algebraic multigrid's Galerkin product ``A_c = R·A·P``, made
from a grid size and seeds: frozen, so that no change to the program can
change what the benchmark feeds it.

* **A**: the 27-point stencil of the 3-D Laplacian on an ``n``³ grid
  (HPCG's operator; the index runs x fastest, then y, then z), with
  float32 standard-normal values from the run's seed, a value set per
  index (a solver's coefficients change every step).
* **Aggregation**: smoothed aggregation's greedy aggregation (Vaněk,
  Mandel, Brezina 1996) with every coupling strong (threshold 0), in row
  order. Pass 1 makes an aggregate of each node whose whole neighbourhood
  is still free; pass 2 puts each node left over in the aggregate of its
  first neighbour, in column order, that pass 1 aggregated. On the
  27-point stencil pass 1's aggregates are the 3 x 3 x 3 boxes around
  the nodes whose coordinates are all multiples of 3, numbered in row
  order, and pass 2 is needed only where ``n`` is a multiple of 3; both
  are computed so here (the tests hold them against the sequential
  greedy).
* **P**: the tentative prolongator P₀ (a 1 at ``(i, aggregate(i))``)
  after one Jacobi smoothing, ``P = (I - ωD⁻¹A)·P₀``, whose pattern is
  that of A·P₀. Its values are float32 standard normals drawn once from
  the seed: the interpolation is kept while A changes.
* **R = Pᵀ**, with P's values.

Every matrix is a canonical :class:`perfbench.gen.Pattern`.
"""
from __future__ import annotations

import numpy as np

from perfbench.gen import Pattern, values

# Value streams of the run's seed.
A_STREAM = 0xA6
P_STREAM = 0x9A


def _offsets():
    """The stencil's 27 offsets ``(dz, dy, dx)``, in ascending order of the
    neighbour's index (column order)."""
    d = np.array([-1, 0, 1])
    dz, dy, dx = np.meshgrid(d, d, d, indexing="ij")
    return dz.ravel(), dy.ravel(), dx.ravel()


def _neighbours(n: int):
    """``[n³, 27]`` neighbour indices of each node in column order, -1 off
    the grid."""
    z, y, x = (c.astype(np.int64)[:, None] for c in np.unravel_index(np.arange(n ** 3),
                                                                      (n, n, n)))
    dz, dy, dx = _offsets()
    zz, yy, xx = z + dz, y + dy, x + dx
    inside = (zz >= 0) & (zz < n) & (yy >= 0) & (yy < n) & (xx >= 0) & (xx < n)
    return np.where(inside, (zz * n + yy) * n + xx, -1)


def stencil(n: int) -> Pattern:
    """The 27-point stencil's pattern on an ``n``³ grid (values 1)."""
    nb = _neighbours(n)
    keep = nb >= 0
    rows = np.broadcast_to(np.arange(n ** 3, dtype=np.int64)[:, None], nb.shape)[keep]
    return Pattern(rows.astype(np.int32), nb[keep].astype(np.int32),
                   np.ones(int(keep.sum()), np.float32), (n ** 3, n ** 3))


def aggregates(n: int):
    """``(aggregate of each node, number of aggregates)`` of the two-pass
    greedy aggregation on the ``n``³ grid."""
    m = (n - 1) // 3 + 1  # pass 1's centres per axis: 0, 3, 6, ...
    k = (np.arange(n) + 1) // 3  # the centre within 1 of each coordinate
    k = np.where(3 * k <= n - 1, k, -1)
    z, y, x = np.unravel_index(np.arange(n ** 3), (n, n, n))
    kz, ky, kx = k[z], k[y], k[x]
    first = np.where((kz >= 0) & (ky >= 0) & (kx >= 0), (kz * m + ky) * m + kx, -1)
    agg = first.copy()
    left = np.flatnonzero(first < 0)
    if left.size:
        nb = _neighbours(n)[left]
        got = np.where(nb >= 0, first[np.maximum(nb, 0)], -1)
        agg[left] = got[np.arange(left.size), np.argmax(got >= 0, axis=1)]
    return agg, m ** 3


def prolongator(n: int) -> Pattern:
    """The pattern of P = A·P₀ (values 1), rows canonical."""
    agg, count = aggregates(n)
    nb = _neighbours(n)
    cols = np.sort(np.where(nb >= 0, agg[np.maximum(nb, 0)], -1), axis=1)
    keep = cols >= 0
    keep[:, 1:] &= cols[:, 1:] != cols[:, :-1]
    rows = np.broadcast_to(np.arange(n ** 3, dtype=np.int64)[:, None], cols.shape)[keep]
    return Pattern(rows.astype(np.int32), cols[keep].astype(np.int32),
                   np.ones(int(keep.sum()), np.float32), (n ** 3, count))


def transpose(p: Pattern) -> Pattern:
    """``pᵀ``, canonical, each entry keeping its value."""
    order = np.argsort(p.col, kind="stable")
    return Pattern(p.col[order], p.row[order], p.val[order], (p.shape[1], p.shape[0]))


def galerkin(n: int, seed: int):
    """``(R, A, P)`` at grid ``n``: A's pattern with its value set 0, P with
    its values from the seed, and R = Pᵀ."""
    a = stencil(n)
    p = prolongator(n)
    p = Pattern(p.row, p.col, values(seed, P_STREAM, 0, p.nnz), p.shape)
    a = Pattern(a.row, a.col, a_values(seed, 0, a.nnz), a.shape)
    return transpose(p), a, p


def a_values(seed: int, j: int, nnz: int) -> np.ndarray:
    """A's value set ``j``."""
    return values(seed, A_STREAM, j, nnz)
