"""Inputs of smoothed-aggregation AMG's Galerkin product ``A_c = R·A·P`` for
3-D linear elasticity, made from a grid size and seeds: frozen, so that no
change to the program can change what the benchmark feeds it.

Trilinear (Q1) hexahedra carry 3 displacement unknowns a node, so every
nodal coupling is a dense 3 x 3 block; the near-null space is the 6 rigid
-body modes, so every node-to-aggregate entry of the tentative prolongator
is a dense 3 x 6 block (PETSc's ``src/snes/tutorials/ex56.c`` under GAMG,
``MatNullSpaceCreateRigidBody``; Vaněk, Mandel, Brezina 1996). The nodal
patterns are :mod:`perfbench.stencil`'s:

* **A**: the 27-point nodal pattern ⊗ a dense 3 x 3 block, unknown
  ``3·node + component``, with float32 standard-normal values from the
  run's seed, a value set per index.
* **P**: ``stencil.prolongator`` ⊗ a dense 3 x 6 block, coarse unknown
  ``6·aggregate + mode`` (the pattern of A·P₀ with P₀'s dense rigid-body
  blocks), with float32 standard-normal values drawn once from the seed.
* **R = Pᵀ**, with P's values.

Values are drawn on the device that is given (:func:`values`: a torch
generator seeded from the seed, the stream and the index), so that 88 M
of them take milliseconds on the card; the same seed gives the same values
on the same kind of device.

Every matrix is a canonical :class:`perfbench.gen.Pattern`: a node's
``br`` rows come in order, and within each the columns of its nodal
neighbours ascend, each neighbour's ``bc`` columns in order.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import stencil
from perfbench.gen import Pattern

# Unknowns per node, and rigid-body modes per aggregate.
DOFS = 3
MODES = 6
# Value streams of the run's seed.
A_STREAM = 0xE1A
P_STREAM = 0xE1B


def expand(p: Pattern, br: int, bc: int) -> Pattern:
    """The canonical pattern of ``p`` ⊗ a dense ``br`` x ``bc`` block
    (values 1): entry ``(i, j)`` of ``p`` becomes rows ``br·i + r`` and
    columns ``bc·j + c``."""
    rows = p.shape[0]
    count = np.bincount(p.row, minlength=rows)
    ptr = np.concatenate([[0], np.cumsum(count)])
    width = int(count.max(initial=0))
    # Each row's nodal columns, padded with -1 to the widest row.
    pad = np.full((rows, max(width, 1)), -1, np.int64)
    pad[p.row, np.arange(p.nnz) - ptr[p.row]] = p.col
    keep = np.broadcast_to((pad >= 0)[:, None, :, None], (rows, br, pad.shape[1], bc))
    r = (br * np.arange(rows, dtype=np.int64))[:, None, None, None] + np.arange(br)[:, None, None]
    c = (bc * pad)[:, None, :, None] + np.arange(bc)
    out_r = np.broadcast_to(r, keep.shape)[keep].astype(np.int32)
    out_c = np.broadcast_to(c, keep.shape)[keep].astype(np.int32)
    return Pattern(out_r, out_c, np.ones(out_r.shape[0], np.float32),
                   (br * p.shape[0], bc * p.shape[1]))


def nodal(n: int):
    """``(A, P)``'s nodal patterns at grid ``n``: the 27-point stencil and
    the smoothed tentative prolongator's pattern."""
    return stencil.stencil(n), stencil.prolongator(n)


def galerkin(n: int, seed: int, device="cpu"):
    """``(R, A, P)`` at grid ``n``: A's pattern with its value set 0, P with
    its values from the seed (drawn on ``device``), and R = Pᵀ."""
    a_node, p_node = nodal(n)
    a = expand(a_node, DOFS, DOFS)
    p = expand(p_node, DOFS, MODES)
    p = Pattern(p.row, p.col, values(seed, P_STREAM, 0, p.nnz, device).cpu().numpy(), p.shape)
    a = Pattern(a.row, a.col, a_values(seed, 0, a.nnz, device).cpu().numpy(), a.shape)
    return stencil.transpose(p), a, p


def values(seed: int, stream: int, index: int, nnz: int, device="cpu") -> torch.Tensor:
    """Float32 standard-normal values on ``device``, a pure function of
    ``(seed, stream, index)`` and the kind of device, exact zeros replaced
    by 1."""
    key = np.random.SeedSequence((seed, stream, index)).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(key[0]) << 31 | int(key[1]) >> 1)
    v = torch.randn(nnz, generator=g, device=device, dtype=torch.float32)
    return v.masked_fill_(v == 0, 1.0)


def a_values(seed: int, j: int, nnz: int, device="cpu") -> torch.Tensor:
    """A's value set ``j``, on ``device``."""
    return values(seed, A_STREAM, j, nnz, device)
