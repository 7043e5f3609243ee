"""Inputs of the benchmark, made from seeds: sparsity patterns, value pools
and pattern perturbations.

These are frozen copies, so that no change to the program can change what
the benchmark feeds it. The pattern generator is the synthetic stand-in
generator of the paper's Table 4 rows (``random_coo`` / ``suite_matrix``
in the port's ``sparse/random.py``) in plain numpy, with one change: its
top-up overshoots, and here the overshoot is trimmed, so that a pattern
holds exactly ``round(rows * cols * density)`` nonzeros. Patterns come out
canonical: row-major, one entry per coordinate.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Pattern:
    """A canonical COO matrix: row-major, no duplicate coordinates."""

    row: np.ndarray  # int32
    col: np.ndarray  # int32
    val: np.ndarray  # float32
    shape: tuple

    @property
    def nnz(self) -> int:
        return int(self.row.shape[0])


def _canonical(row, col, val, shape) -> Pattern:
    """Sort row-major and merge duplicate coordinates by summing."""
    order = np.lexsort((col, row))
    r, c, v = row[order], col[order], val[order]
    if r.shape[0] == 0:
        return Pattern(r.astype(np.int32), c.astype(np.int32), v, tuple(shape))
    change = np.empty(r.shape[0], dtype=bool)
    change[0] = True
    change[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    idx = np.cumsum(change) - 1
    out = np.zeros(int(idx[-1]) + 1, dtype=v.dtype)
    np.add.at(out, idx, v)
    return Pattern(r[change].astype(np.int32), c[change].astype(np.int32), out, tuple(shape))


def _draw_coords(rng, rows: int, cols: int, nnz: int, structure: str):
    """Coordinates of one draw of a structure class (the stand-in classes
    of the paper's Table 4 matrices)."""
    if structure == "uniform":
        r = rng.integers(0, rows, nnz)
        c = rng.integers(0, cols, nnz)
    elif structure == "fem":
        # Banded stencil: nonzeros in a band of width ~sqrt(rows).
        bandwidth = max(4, int(np.sqrt(rows)))
        r = rng.integers(0, rows, nnz)
        off = np.rint(rng.normal(0.0, bandwidth / 3.0, nnz)).astype(np.int64)
        c = np.clip(r + off, 0, cols - 1)
    elif structure == "graph":
        # Power-law column popularity.
        r = rng.integers(0, rows, nnz)
        u = rng.random(nnz)
        alpha = 1.3
        c = np.floor(cols * u ** (1.0 / (1.0 - alpha)) % cols).astype(np.int64)
        c = np.clip(c, 0, cols - 1)
    elif structure == "circuit":
        # Near-diagonal with a few dense rows (rails).
        n_rail = max(1, rows // 2000)
        rails = rng.choice(rows, n_rail, replace=False)
        n_rail_nnz = nnz // 10
        r1 = rng.choice(rails, n_rail_nnz)
        c1 = rng.integers(0, cols, n_rail_nnz)
        n_rest = nnz - n_rail_nnz
        r2 = rng.integers(0, rows, n_rest)
        off = np.rint(rng.normal(0.0, 8.0, n_rest)).astype(np.int64)
        c2 = np.clip(r2 + off, 0, cols - 1)
        r = np.concatenate([r1, r2])
        c = np.concatenate([c1, c2])
    else:
        raise ValueError(f"unknown structure {structure!r}")
    return r, c


def _random_coo_once(rows, cols, nnz, structure, seed) -> Pattern:
    rng = np.random.default_rng(seed)
    r, c = _draw_coords(rng, rows, cols, nnz, structure)
    v = rng.standard_normal(nnz).astype(np.float32)
    v = np.where(v == 0, np.float32(1.0), v)
    return _canonical(r.astype(np.int32), c.astype(np.int32), v, (rows, cols))


def random_pattern(rows: int, cols: int, density: float, structure: str,
                   seed: int) -> Pattern:
    """A synthetic matrix of a structure class at a density: topped up over
    up to four draws so that merged duplicates do not thin it, then trimmed
    by a draw from ``seed`` to exactly the density's nonzeros."""
    target = max(1, int(round(rows * cols * density)))
    acc = None
    for round_ in range(4):
        need = target - (acc.nnz if acc is not None else 0)
        if need <= 0:
            break
        part = _random_coo_once(rows, cols, int(need * 1.15) + 1, structure,
                                seed + 101 * round_)
        if acc is None:
            acc = part
        else:
            acc = _canonical(np.concatenate([acc.row, part.row]),
                             np.concatenate([acc.col, part.col]),
                             np.concatenate([acc.val, part.val]), (rows, cols))
    if acc.nnz > target:
        keep = np.ones(acc.nnz, dtype=bool)
        keep[np.random.default_rng((seed, 0x7219)).choice(acc.nnz, acc.nnz - target,
                                                          replace=False)] = False
        acc = Pattern(acc.row[keep], acc.col[keep], acc.val[keep], acc.shape)
    return acc


def matrix(spec: dict) -> Pattern:
    """The pattern a configuration's matrix entry names: ``rows``, ``cols``,
    ``density``, ``structure`` and ``pattern_seed``."""
    return random_pattern(int(spec["rows"]), int(spec["cols"]), float(spec["density"]),
                          spec["structure"], int(spec["pattern_seed"]))


def values(seed: int, stream: int, index: int, nnz: int) -> np.ndarray:
    """Float32 standard-normal values, a pure function of ``(seed, stream,
    index)`` (the value stream's draw), exact zeros replaced by 1."""
    rng = np.random.default_rng((seed, stream, index))
    v = rng.standard_normal(nnz, dtype=np.float32)
    return np.where(v == 0, np.float32(1.0), v)


def perturb(p: Pattern, share: float, seed: int, index: int) -> Pattern:
    """``p`` with ``share`` of its nonzeros dropped and as many re-drawn
    near the diagonal (the fem band), values drawn anew from the seed."""
    rng = np.random.default_rng((seed, 0x9E37, index))
    rows, cols = p.shape
    n = int(round(p.nnz * share))
    keep = np.ones(p.nnz, dtype=bool)
    keep[rng.choice(p.nnz, n, replace=False)] = False
    r, c = _draw_coords(rng, rows, cols, n, "fem")
    row = np.concatenate([p.row[keep], r.astype(np.int32)])
    col = np.concatenate([p.col[keep], c.astype(np.int32)])
    # Merged duplicates sum their values, so values are drawn after the merge.
    q = _canonical(row, col, np.zeros(row.shape[0], np.float32), p.shape)
    return dataclasses.replace(q, val=values(seed, 0x9E38, index, q.nnz))
