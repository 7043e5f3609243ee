"""Algebraic multigrid's Galerkin product ``A_c = R·A·P`` (``R = Pᵀ``),
recomputed as a solver's coefficients change: R and P are fixed (the
interpolation is reused), A brings new values each request, already on the
card, where a GPU solver assembles them.

Set-up plans the chain once, ``spgemm_plan(R, A).then(P)`` at the
configuration's tile, group and output, and sends A's value sets to the
device once. A request is one ``execute_chain(chain, b_vals=...)`` on the
client's own device copy of a value set, with one value stamped by the
request's index (as the execute entry stamps its host copies); it returns
A_c as host CSR. The inputs come from ``perfbench.stencil``; the
reference chains two ``perfbench.reference.ExactProduct``: R·A, then
(R·A)·P, in float64, each entry's scale the sum of its products'
magnitudes Σ|r|·|a|·|p|."""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from perfbench import gen, reference, stencil, work
from perfbench.systems.spgemm import Entry as _Entry
from perfbench.systems.spgemm import coo


def chain_least_seconds(pairs: int, nnz_r: int, nnz_a: int, nnz_p: int, nnz_c: int,
                        peaks: dict):
    """The chain's least chip time: 2 operations per pair of both stages;
    R's, A's and P's values and column indices read once and A_c's written
    once (the intermediate R·A need never leave the chip)."""
    return work.least_seconds(2 * pairs, work.product_bytes(nnz_r, nnz_a, nnz_p)
                              + nnz_c * (work.VALUE_BYTES + work.INDEX_BYTES), peaks)


class Entry(_Entry):
    """The shared entry's counters and release; the products, the values,
    the check and the least time are the chain's own."""

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
                  output=config["output"], cache=spgemm.PlanCache())
        # A program that cannot chain this output fails here, in a second,
        # before the symbolic phase of the full product.
        one = coo(gen.Pattern(np.zeros(1, np.int32), np.zeros(1, np.int32),
                              np.ones(1, np.float32), (1, 1)))
        spgemm.spgemm_plan(one, one, **kw).then(one, cache=kw["cache"])
        self.r, self.a, self.p = stencil.galerkin(int(config["grid"]), seed)
        self.sets = int(traffic["value_sets"])
        self.pool = [torch.from_numpy(stencil.a_values(seed, j, self.a.nnz)).to(self.device)
                     for j in range(self.sets)]
        self.chain = spgemm.spgemm_plan(coo(self.r), coo(self.a), **kw).then(
            coo(self.p), cache=kw["cache"])
        self._exact = None
        # Warm-up on requests outside the window's range of indices.
        for i in (-1, -2):
            self.call(i)

    def product(self, i):
        return "RAP"

    def values(self, i) -> torch.Tensor:
        """A's values of request ``i`` on the device: a copy of value set
        ``i % value_sets``, one value stamped by the request's index."""
        v = self.pool[i % self.sets].clone()
        v[i % v.shape[0]] = float(gen.values(self.seed, 0x57A3, i & 0xFFFFFFFF, 1)[0])
        return v

    def call(self, i):
        a_vals = self.values(i)
        with record_function("perfbench.execute_chain"):
            return self.execute_chain(self.chain, b_vals=a_vals)

    def _release(self):
        for plan in self.chain.plans:
            plan.release()
        self.chain = None

    # -- the reference --------------------------------------------------------

    def stages(self):
        """The two stages' structural products: R·A, then its pattern times P."""
        if self._exact is None:
            ra = reference.ExactProduct(self.r, self.a, self.device)
            n = ra.shape[1]
            rows = torch.div(ra.keys, n, rounding_mode="floor")
            pattern = gen.Pattern(rows.to(torch.int32).cpu().numpy(),
                                  (ra.keys - rows * n).to(torch.int32).cpu().numpy(),
                                  None, ra.shape)
            self._exact = ra, reference.ExactProduct(pattern, self.p, self.device)
        return self._exact

    def _stage(self, ex, x, y, dtype):
        out = torch.zeros(ex.nnz, dtype=dtype, device=self.device)
        return out.index_add_(0, ex.inverse, x[ex.a_idx] * y[ex.b_idx])

    def reference(self, a_vals):
        """A_c in float64 on the second stage's pattern, and each entry's
        Σ|r|·|a|·|p|."""
        ra, rap = self.stages()
        r, p, a = (torch.as_tensor(x).to(self.device, torch.float64)
                   for x in (self.r.val, self.p.val, a_vals))
        c, s = self._stage(ra, r, a, torch.float64), self._stage(ra, r.abs(), a.abs(),
                                                                 torch.float64)
        return self._stage(rap, c, p, torch.float64), self._stage(rap, s, p.abs(),
                                                                  torch.float64)

    def control(self, a_vals) -> np.ndarray:
        """The chain one precision down: TF32 operands at both stages,
        float32 sums."""
        ra, rap = self.stages()
        r, p, a = (reference.tf32(torch.as_tensor(x).to(self.device, torch.float32))
                   for x in (self.r.val, self.p.val, a_vals))
        c = reference.tf32(self._stage(ra, r, a, torch.float32))
        return self._stage(rap, c, p, torch.float32).cpu().numpy()

    def check(self, kept: dict, control: bool = False) -> tuple:
        out = {"c_err": 0.0, "c_missing": 0, "c_extra": 0, "c_structure": 0}
        for i, c in sorted(kept.items()):
            a_vals = self.values(i)
            ref, scale = self.reference(a_vals)
            rap = self.stages()[1]
            got = rap.csr(self.control(a_vals)) if control else (c.indptr, c.indices, c.data)
            r = reference.compare(rap, ref, scale, *got)
            out["c_err"] = max(out["c_err"], r["c_err"])
            for k in ("c_missing", "c_extra", "c_structure"):
                out[k] += r[k]
        if not kept:
            out["c_err"] = reference.NONFINITE
        return out, len(kept)

    def extra_checks(self, counters: dict, requests: list) -> dict:
        """On the card, every completed request launched the element
        kernel twice, once per stage."""
        if self.device.type != "cuda":
            return {}
        done = sum(1 for r in requests if r.ok)
        return {"k1_launch_gap": abs(counters.get("k1_launches", 0) - 2 * done)}

    def least_seconds(self, i):
        if self.peaks is None:
            return None
        ra, rap = self.stages()
        return chain_least_seconds(ra.pairs + rap.pairs, self.r.nnz, self.a.nnz,
                                   self.p.nnz, rap.nnz, self.peaks)
