"""SpGEMM served by the port, ``repro_torch.spgemm``: what the entries of
every configuration whose ``system`` is ``spgemm`` share.

A configuration names its matrices (patterns made by ``perfbench.gen``
from the configuration's pattern seeds) and its products (``"AA": ["A",
"A"]``). Values are float32 draws from the run's seed. In an A·A product
the two operands are one matrix, so B's values are A's. The program is
handed the benchmark's inputs and nothing else, and its results are judged
by ``perfbench.reference`` on the same inputs.
"""
from __future__ import annotations

import gc

import torch

from perfbench import gen, reference, work


class Product:
    """One product of a configuration, ``C = A·B``, and its value draws."""

    def __init__(self, name: str, index: int, a_name: str, b_name: str, mats: dict):
        self.name = name
        self.index = index
        self.a = mats[a_name]
        self.b = mats[b_name]
        self.same = a_name == b_name

    def value_set(self, seed: int, j: int):
        a = gen.values(seed, 2 * self.index, j, self.a.nnz)
        b = a if self.same else gen.values(seed, 2 * self.index + 1, j, self.b.nnz)
        return a, b


def coo(p: gen.Pattern, val=None):
    """``p`` as the port's COO."""
    from repro_torch.sparse.formats import COO

    return COO(p.row, p.col, p.val if val is None else val, p.shape)


class Entry:
    """What the entries share: the configuration's products, the reference
    check and the work of each request. A subclass says what request ``i``
    computes (``patterns``, ``values``) and how it is served (``call``)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config = config
        self.device = torch.device(device)
        used = traffic["products"]
        mats = {n: gen.matrix(s) for n, s in config["matrices"].items()
                if any(n in config["products"][p] for p in used)}
        self.products = {name: Product(name, i, *config["products"][name], mats)
                         for i, name in enumerate(sorted(config["products"])) if name in used}
        self.order = list(used)
        self.spans: dict = {}
        self._exact: dict = {}
        name = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu"
        self.peaks = work.peak(name)
        self.plan_kwargs = dict(tile=int(config["tile"]), group=int(config["group"]),
                                device=self.device, output=config["output"])
        if config["value_dtype"] != "float32":
            raise ValueError(f"value dtype {config['value_dtype']!r}: the pools are float32")

    # -- what request i computes -------------------------------------------

    def patterns(self, i: int):
        """``(key, A, B)`` of request ``i``: ``key`` names the pattern pair."""
        raise NotImplementedError

    def values(self, i: int):
        """``(a_vals, b_vals)`` that request ``i`` hands the program."""
        raise NotImplementedError

    def product(self, i: int) -> str:
        raise NotImplementedError

    def exact(self, key, a, b) -> reference.ExactProduct:
        if key not in self._exact:
            self._exact[key] = reference.ExactProduct(a, b, self.device)
        return self._exact[key]

    def least_seconds(self, i: int):
        """The least chip time of request ``i``'s product (``None`` on a
        card the table of peaks does not hold)."""
        if self.peaks is None:
            return None
        key, a, b = self.patterns(i)
        ex = self.exact(key, a, b)
        if not hasattr(ex, "least_s"):
            ex.least_s = work.least_seconds(
                work.product_flops(a, b), work.product_bytes(a.nnz, b.nnz, ex.nnz), self.peaks)
        return ex.least_s

    # -- the comparison ---------------------------------------------------------

    def check(self, kept: dict, control: bool = False) -> tuple:
        """Each kept result against the reference; with ``control``, the
        reference one precision down in the program's place. Returns the
        worst numbers and how many results were compared."""
        out = {"c_err": 0.0, "c_missing": 0, "c_extra": 0, "c_structure": 0}
        for i, c in sorted(kept.items()):
            key, a, b = self.patterns(i)
            av, bv = self.values(i)
            ex = self.exact(key, a, b)
            ref, scale = ex.values(av, bv)
            got = ex.csr(ex.control(av, bv)) if control else (c.indptr, c.indices, c.data)
            r = reference.compare(ex, ref, scale, *got)
            out["c_err"] = max(out["c_err"], r["c_err"])
            for k in ("c_missing", "c_extra", "c_structure"):
                out[k] += r[k]
        if not kept:
            out["c_err"] = reference.NONFINITE
        return out, len(kept)

    def extra_checks(self, counters: dict, requests: list) -> dict:
        """On the card, every completed request launched K1 once: no result
        was served without its product computed. (The plain version that
        runs on the CPU counts no launches.)"""
        if self.device.type != "cuda":
            return {}
        done = sum(1 for r in requests if r.ok)
        return {"k1_launch_gap": abs(counters.get("k1_launches", 0) - done)}

    def counters(self) -> dict:
        from repro_torch.kernels import gustavson_spgemm as k
        from repro_torch.spgemm import schedule_build_count

        return {"k1_launches": k.spgemm_scheduled.launches,
                "k2_launches": k.spgemm_scheduled_batch.launches,
                "schedule_builds": schedule_build_count()}

    def release(self) -> None:
        """Free the program's state (plans) before the reference runs."""
        self._release()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def _release(self) -> None:
        pass
