"""Smoothed-aggregation AMG's Galerkin product ``A_c = R·A·P`` for 3-D linear
elasticity (``perfbench.elastic``: 3 x 3 node blocks in A, 3 x 6 in P),
recomputed as a solver's coefficients change: R and P are fixed (the
interpolation is reused), A brings new values each request, already on the
card, where a GPU solver assembles them.

The galerkin entry's request, least time and launch check, on block plans:
set-up plans the chain once, ``spgemm_plan(R, A).then(P)`` at the
configuration's tile, group and output, and sends A's value sets to the
device once (values are drawn there). Before that, and before any
full-size input is made, it
plans and executes a chain of the same kind at grid 2, with A's values
handed over on the device: a program that cannot run this tile on the card
fails there, in seconds. A request is one ``execute_chain(chain,
b_vals=...)`` on the client's own device copy of a value set, one value
stamped by the request's index; it returns A_c as host CSR.

The reference (:class:`ChainReference`) is plain PyTorch on the inputs
alone: R·A, then (R·A)·P, every pair formed and summed into its
coordinate in float64, each entry's scale the sum of its products'
magnitudes Σ|r|·|a|·|p|. At 72³ the chain forms 4.25 G pairs, so it runs
on chunks of R's rows, each chunk's two stages at once, after the
program's state is freed."""
from __future__ import annotations

import numpy as np
import torch

from perfbench import elastic, reference, work
from perfbench.systems.spgemm import coo, galerkin

# Stage-1 pairs of one chunk of the reference (int64 indices: ~0.5 GB each).
CHUNK_PAIRS = 1 << 26


class _ChainPattern(reference.ExactProduct):
    """A_c's structural pattern, gathered chunk by chunk: the keys, shape
    and device that :func:`perfbench.reference.compare` and ``csr`` read."""

    def __init__(self, keys: torch.Tensor, shape, device):
        self.keys, self.shape, self.device = keys, tuple(shape), torch.device(device)


def _expand(rows, cols, ptr, length, other_cols, n):
    """Every pair of the entries ``(rows, cols)`` with the rows of the CSR
    operand (``ptr``, ``length``, ``other_cols``): ``(left entry, right
    entry, inverse into the sorted unique keys, keys)``, keys ``row·n +
    column``."""
    dev = rows.device
    cnt = length[cols]
    pairs = int(cnt.sum())
    left = torch.repeat_interleave(torch.arange(rows.shape[0], device=dev), cnt,
                                   output_size=pairs)
    first = (torch.cumsum(cnt, 0) - cnt)[left]
    right = ptr[cols][left] + torch.arange(pairs, device=dev) - first
    keys, inverse = torch.unique(rows[left] * n + other_cols[right], sorted=True,
                                 return_inverse=True)
    return left, right, inverse, keys


class ChainReference:
    """``R·A·P`` on its structural pattern, in float64, on ``device``, by
    chunks of R's rows of at most ``chunk_pairs`` stage-1 pairs (a row
    more where one row holds more)."""

    def __init__(self, r, a, p, device, chunk_pairs: int = CHUNK_PAIRS):
        self.device = torch.device(device)
        self.shape = (r.shape[0], p.shape[1])
        self.mid = a.shape[1]

        def csr(m):
            length = torch.bincount(reference._tensor(m.row, self.device, torch.int64),
                                    minlength=m.shape[0])
            return (torch.cumsum(length, 0) - length, length,
                    reference._tensor(m.col, self.device, torch.int64))

        self.a_ptr, self.a_len, self.a_col = csr(a)
        self.p_ptr, self.p_len, self.p_col = csr(p)
        self.r_row = reference._tensor(r.row, self.device, torch.int64)
        self.r_col = reference._tensor(r.col, self.device, torch.int64)
        self.r_val = reference._tensor(r.val, self.device, torch.float64)
        self.p_val = reference._tensor(p.val, self.device, torch.float64)
        # Stage-1 pairs of each of R's rows, and the chunks' entry bounds.
        per_entry = np.bincount(a.row, minlength=a.shape[0])[r.col].astype(np.int64)
        per_row = np.bincount(r.row, weights=per_entry, minlength=r.shape[0]).astype(np.int64)
        self.pairs1 = int(per_row.sum())
        ptr = np.concatenate([[0], np.cumsum(np.bincount(r.row, minlength=r.shape[0]))])
        cum = np.cumsum(per_row)
        bounds = [0]
        while bounds[-1] < r.shape[0]:
            done = int(cum[bounds[-1] - 1]) if bounds[-1] else 0
            nxt = int(np.searchsorted(cum, done + chunk_pairs, side="right"))
            bounds.append(min(r.shape[0], max(nxt, bounds[-1] + 1)))
        self.entry_bounds = [(int(ptr[lo]), int(ptr[hi])) for lo, hi in zip(bounds, bounds[1:])]
        self.pairs2 = self.mid_nnz = None
        self.pattern = None

    @property
    def pairs(self) -> int:
        """Scalar products of both stages (after a first :meth:`run`)."""
        if self.pairs2 is None:
            self.run([])
        return self.pairs1 + self.pairs2

    def run(self, a_sets, control: bool = False):
        """For each of ``a_sets`` (A's values): ``(A_c, scale)`` in float64
        on the pattern, and with ``control`` the chain one precision down
        (TF32 operands at both stages, float32 sums) as a numpy array. Sets
        ``pattern``, ``pairs2`` and ``mid_nnz`` (R·A's entries)."""
        n1, n2 = self.mid, self.shape[1]
        a64 = [torch.as_tensor(a).to(self.device, torch.float64) for a in a_sets]
        out = [([], [], []) for _ in a_sets]
        keys_all, pairs2, mid_nnz = [], 0, 0
        for e0, e1 in self.entry_bounds:
            rows, cols = self.r_row[e0:e1], self.r_col[e0:e1]
            left1, right1, inv1, keys1 = _expand(rows, cols, self.a_ptr, self.a_len,
                                                 self.a_col, n1)
            left1 += e0
            ra_rows = torch.div(keys1, n1, rounding_mode="floor")
            left2, right2, inv2, keys2 = _expand(ra_rows, keys1 - ra_rows * n1, self.p_ptr,
                                                 self.p_len, self.p_col, n2)
            del ra_rows
            pairs2 += int(left2.shape[0])
            mid_nnz += int(keys1.shape[0])
            keys_all.append(keys2)
            r, p = self.r_val[left1], self.p_val[right2]
            for a, (ref, scale, ctrl) in zip(a64, out):
                av = a[right1]
                c1 = torch.zeros(keys1.shape[0], dtype=torch.float64, device=self.device)
                s1 = torch.zeros_like(c1)
                c1.index_add_(0, inv1, r * av)
                s1.index_add_(0, inv1, (r * av).abs_())
                c2 = torch.zeros(keys2.shape[0], dtype=torch.float64, device=self.device)
                s2 = torch.zeros_like(c2)
                c2.index_add_(0, inv2, c1[left2] * p)
                s2.index_add_(0, inv2, s1[left2] * p.abs())
                ref.append(c2)
                scale.append(s2)
                if control:
                    t1 = torch.zeros(keys1.shape[0], dtype=torch.float32, device=self.device)
                    t1.index_add_(0, inv1, reference.tf32(r.float()) * reference.tf32(av.float()))
                    t2 = torch.zeros(keys2.shape[0], dtype=torch.float32, device=self.device)
                    t2.index_add_(0, inv2, reference.tf32(t1)[left2] * reference.tf32(p.float()))
                    ctrl.append(t2)
            del left1, right1, inv1, keys1, left2, right2, inv2, r, p
        self.pairs2, self.mid_nnz = pairs2, mid_nnz
        self.pattern = _ChainPattern(torch.cat(keys_all), self.shape, self.device)
        return [(torch.cat(ref), torch.cat(scale),
                 torch.cat(ctrl).cpu().numpy() if control else None)
                for ref, scale, ctrl in out]


class Entry(galerkin.Entry):
    """The galerkin entry's values, call, release and launch check; the
    inputs, the probe, the reference and the least time are the block
    chain's own."""

    def __init__(self, config, traffic, seed, device):
        import repro_torch.spgemm as spgemm

        self.config = config
        self.device = torch.device(device)
        self.spans: dict = {}
        if config["value_dtype"] != "float32":
            raise ValueError(f"value dtype {config['value_dtype']!r}: the pools are float32")
        name = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu"
        self.peaks = work.peak(name)
        self.seed = seed
        self.execute_chain = spgemm.execute_chain
        kw = dict(tile=int(config["tile"]), group=int(config["group"]), device=self.device,
                  output=config["output"])
        # A program that cannot run this chain on the card fails here, in
        # seconds, before the full product's inputs or symbolic phase.
        r, a, p = elastic.galerkin(2, seed, self.device)
        probe = spgemm.spgemm_plan(coo(r), coo(a), cache=spgemm.PlanCache(), **kw).then(
            coo(p), cache=spgemm.PlanCache())
        self.execute_chain(probe, b_vals=torch.from_numpy(a.val).to(self.device))
        for plan in probe.plans:
            plan.release()
        self.r, self.a, self.p = elastic.galerkin(int(config["grid"]), seed, self.device)
        self.sets = int(traffic["value_sets"])
        self.pool = [elastic.a_values(seed, j, self.a.nnz, self.device)
                     for j in range(self.sets)]
        cache = spgemm.PlanCache()
        self.chain = spgemm.spgemm_plan(coo(self.r), coo(self.a), cache=cache, **kw).then(
            coo(self.p), cache=cache)
        self._ref = None
        for i in (-1, -2):
            self.call(i)

    def reference_chain(self) -> ChainReference:
        if self._ref is None:
            self._ref = ChainReference(self.r, self.a, self.p, self.device)
        return self._ref

    def check(self, kept: dict, control: bool = False) -> tuple:
        out = {"c_err": 0.0, "c_missing": 0, "c_extra": 0, "c_structure": 0}
        if not kept:
            out["c_err"] = reference.NONFINITE
            return out, 0
        items = sorted(kept.items())
        chain = self.reference_chain()
        results = chain.run([self.values(i) for i, _ in items], control)
        for (i, c), (ref, scale, ctrl) in zip(items, results):
            got = chain.pattern.csr(ctrl) if control else (c.indptr, c.indices, c.data)
            r = reference.compare(chain.pattern, ref, scale, *got)
            out["c_err"] = max(out["c_err"], r["c_err"])
            for k in ("c_missing", "c_extra", "c_structure"):
                out[k] += r[k]
        return out, len(items)

    def least_seconds(self, i):
        if self.peaks is None:
            return None
        chain = self.reference_chain()
        pairs = chain.pairs
        return galerkin.chain_least_seconds(pairs, self.r.nnz, self.a.nnz, self.p.nnz,
                                            chain.pattern.nnz, self.peaks)
