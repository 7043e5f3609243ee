"""Synthetic sparse matrix generation.

The paper evaluates on 8 SuiteSparse matrices (Table 4). This container has
no network access, so we synthesize matrices with the *published dimensions
and densities* and a structure class matching each matrix's provenance:

* ``fem``      — banded + local stencil couplings (poisson3Da, 2cubes_sphere,
                 filter3D, offshore): nonzeros clustered near the diagonal.
* ``graph``    — power-law degree distribution (webbase-1M, cage12).
* ``circuit``  — sparse quasi-symmetric with a few dense rows/cols
                 (scircuit, mac_econ_fwd500).
* ``uniform``  — iid Erdos-Renyi (control).

``suite_matrix(name, scale=...)`` reproduces Table 4's spec; ``scale < 1``
shrinks dimensions (keeping density) so CI-sized runs stay fast.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from repro_torch.sparse.formats import COO, CSR


@dataclasses.dataclass(frozen=True)
class MatrixSpec:
    """One row of the paper's Table 4."""

    name: str
    rows: int
    cols: int
    density: float
    structure: str  # fem | graph | circuit | uniform

    @property
    def nnz(self) -> int:
        return int(round(self.rows * self.cols * self.density))


# Paper Table 4 (dimensions use the paper's K = 1000-based rounding; offshore
# is 260K x 260K — the "260 x 260K" in the table is a typo in the original).
SUITE: Dict[str, MatrixSpec] = {
    "poisson3Da": MatrixSpec("poisson3Da", 14_000, 14_000, 1.9e-3, "fem"),
    "2cubes_sphere": MatrixSpec("2cubes_sphere", 101_000, 101_000, 1.6e-4, "fem"),
    "filter3D": MatrixSpec("filter3D", 106_000, 106_000, 2.4e-4, "fem"),
    "cage12": MatrixSpec("cage12", 130_000, 130_000, 1.2e-4, "graph"),
    "scircuit": MatrixSpec("scircuit", 171_000, 171_000, 3.3e-5, "circuit"),
    "mac_econ_fwd500": MatrixSpec("mac_econ_fwd500", 207_000, 207_000, 3.0e-5, "circuit"),
    "offshore": MatrixSpec("offshore", 260_000, 260_000, 6.3e-5, "fem"),
    "webbase-1M": MatrixSpec("webbase-1M", 1_000_000, 1_000_000, 3.1e-6, "graph"),
}


def random_coo(
    rows: int,
    cols: int,
    density: float,
    structure: str = "uniform",
    seed: int = 0,
    dtype=np.float32,
) -> COO:
    """Generate a synthetic sparse matrix of the given structure class.

    Duplicate coordinates (common for the banded classes at small scale)
    are topped up so the realized nnz tracks the requested density.
    """
    target = max(1, int(round(rows * cols * density)))
    acc: COO | None = None
    for round_ in range(4):
        need = target - (acc.nnz if acc is not None else 0)
        if need <= 0:
            break
        part = _random_coo_once(rows, cols, int(need * 1.15) + 1, structure,
                                seed + 101 * round_, dtype)
        if acc is None:
            acc = part
        else:
            import numpy as _np
            acc = COO(
                _np.concatenate([acc.row, part.row]),
                _np.concatenate([acc.col, part.col]),
                _np.concatenate([acc.val, part.val]),
                (rows, cols),
            ).sum_duplicates()
    return acc.sort_rowmajor()


def _random_coo_once(
    rows: int,
    cols: int,
    nnz: int,
    structure: str,
    seed: int,
    dtype,
) -> COO:
    rng = np.random.default_rng(seed)
    if structure == "uniform":
        r = rng.integers(0, rows, nnz)
        c = rng.integers(0, cols, nnz)
    elif structure == "fem":
        # Banded stencil: nonzeros within a narrow band around the diagonal,
        # plus per-row clustering (each row couples to ~nnz/rows neighbours).
        bandwidth = max(4, int(np.sqrt(rows)))
        r = rng.integers(0, rows, nnz)
        off = np.rint(rng.normal(0.0, bandwidth / 3.0, nnz)).astype(np.int64)
        c = np.clip(r + off, 0, cols - 1)
    elif structure == "graph":
        # Power-law (Zipf) column popularity: a few hub columns, heavy tail.
        r = rng.integers(0, rows, nnz)
        u = rng.random(nnz)
        # Inverse-CDF sample from a truncated zipf-like distribution.
        alpha = 1.3
        c = np.floor(cols * u ** (1.0 / (1.0 - alpha)) % cols).astype(np.int64)
        c = np.clip(c, 0, cols - 1)
    elif structure == "circuit":
        # Mostly near-diagonal with a sparse set of dense rows (rails).
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
    v = rng.standard_normal(nnz).astype(dtype)
    # Avoid exact zeros so nnz is stable under dedup-by-value.
    v = np.where(v == 0, dtype(1.0), v)
    coo = COO(r.astype(np.int32), c.astype(np.int32), v, (rows, cols))
    return coo.sum_duplicates().sort_rowmajor()


def suite_matrix(name: str, scale: float = 1.0, seed: int = 0) -> CSR:
    """Synthetic stand-in for a Table 4 matrix, optionally scaled down."""
    spec = SUITE[name]
    rows = max(64, int(spec.rows * scale))
    cols = max(64, int(spec.cols * scale))
    # Keep nnz-per-row constant when scaling so the work profile matches.
    density = min(1.0, spec.density / max(scale, 1e-9))
    coo = random_coo(rows, cols, density, spec.structure, seed=seed)
    return CSR.from_coo(coo)


def random_block_sparse(
    rows: int,
    cols: int,
    block_shape: Tuple[int, int],
    block_density: float,
    seed: int = 0,
    dtype=np.float32,
) -> np.ndarray:
    """Dense array whose nonzero support is block-structured (for kernels)."""
    rng = np.random.default_rng(seed)
    bm, bk = block_shape
    if rows % bm or cols % bk:
        raise ValueError("dims must divide block shape")
    gm, gk = rows // bm, cols // bk
    mask = rng.random((gm, gk)) < block_density
    if not mask.any():
        mask[rng.integers(0, gm), rng.integers(0, gk)] = True
    dense = rng.standard_normal((rows, cols)).astype(dtype)
    dense *= np.repeat(np.repeat(mask, bm, axis=0), bk, axis=1)
    return dense
