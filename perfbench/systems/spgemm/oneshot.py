"""A request is ``spgemm_plan`` on a pattern new to the program (a fresh
plan cache, no disk tier) and one ``execute`` of the values it carries: the
one-call product. The patterns are the configuration's, each with
``perturb_share`` of its nonzeros re-drawn near the diagonal, made at
set-up from the seed; the harness checks that every request built its
schedule."""
from __future__ import annotations

import dataclasses
import time

from torch.profiler import record_function

from perfbench import gen
from perfbench.systems.spgemm import Entry as _Entry
from perfbench.systems.spgemm import coo


class Entry(_Entry):
    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        if len(self.products) != 1:
            raise ValueError("a oneshot mix serves one product")
        self.p = next(iter(self.products.values()))
        share = float(traffic["perturb_share"])
        n = int(traffic["patterns"])
        # Pattern n (outside the pool) is the warm-up's.
        self.a_pool = [gen.perturb(self.p.a, share, seed, j) for j in range(n + 1)]
        self.b_pool = (self.a_pool if self.p.same else
                       [_fresh_values(self.p.b, seed, j) for j in range(n + 1)])
        self.n = n
        self.coo = [(coo(a), coo(b) if b is not a else None)
                    for a, b in zip(self.a_pool, self.b_pool)]
        self.not_built = 0
        self._request(n)
        self._request(n)
        self.spans = {"spgemm_plan": []}
        self.not_built = 0

    def product(self, i):
        return self.p.name

    def patterns(self, i):
        j = i % self.n
        return ("oneshot", j), self.a_pool[j], self.b_pool[j]

    def values(self, i):
        _, a, b = self.patterns(i)
        return a.val, b.val

    def call(self, i):
        return self._request(i % self.n)

    def _request(self, j):
        from repro_torch.spgemm import PlanCache, schedule_build_count, spgemm_plan

        a, b = self.coo[j]
        before = schedule_build_count()
        t = time.perf_counter()
        with record_function("perfbench.spgemm_plan"):
            plan = spgemm_plan(a, a if b is None else b, cache=PlanCache(), **self.plan_kwargs)
        self.spans.setdefault("spgemm_plan", []).append(time.perf_counter() - t)
        if plan.report.schedule_builds != 1 or schedule_build_count() != before + 1:
            self.not_built += 1
        with record_function("perfbench.execute"):
            return plan.execute()

    def extra_checks(self, counters, requests):
        return dict(super().extra_checks(counters, requests), plan_not_built=self.not_built)


def _fresh_values(p: gen.Pattern, seed: int, j: int) -> gen.Pattern:
    """``p`` with values drawn anew for oneshot pattern ``j``."""
    return dataclasses.replace(p, val=gen.values(seed, 0x9E39, j, p.nnz))
