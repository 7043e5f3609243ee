"""Plan once at set-up; a request is one ``plan.execute(a_vals, b_vals)``,
which returns C as host CSR.

Each request hands the program its own copy of a value set from a pool
made from the seed, with one value stamped by the request's index, so that
no two requests carry the same buffer or the same values, as a solver's
steps never do."""
from __future__ import annotations

import numpy as np
from torch.profiler import record_function

from perfbench import gen
from perfbench.systems.spgemm import Entry as _Entry
from perfbench.systems.spgemm import coo


class Entry(_Entry):
    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        from repro_torch.spgemm import PlanCache, spgemm_plan

        self.seed = seed
        self.sets = int(traffic["value_sets"])
        self.pool = {p.name: [p.value_set(seed, j) for j in range(self.sets)]
                     for p in self.products.values()}
        self.plans = {p.name: spgemm_plan(coo(p.a), coo(p.b), cache=PlanCache(),
                                          **self.plan_kwargs)
                      for p in self.products.values()}
        # Warm-up on requests outside the window's range of indices: every
        # product twice.
        for i in range(2 * len(self.order)):
            self.call(-1 - i)

    def product(self, i):
        return self.order[i % len(self.order)]

    def patterns(self, i):
        p = self.products[self.product(i)]
        return p.name, p.a, p.b

    def values(self, i):
        p = self.products[self.product(i)]
        a_pool, b_pool = self.pool[p.name][(i // len(self.order)) % self.sets]
        stamp = gen.values(self.seed, 0x57A3, i & 0xFFFFFFFF, 2)
        a = np.array(a_pool, copy=True)
        a[i % a.shape[0]] = stamp[0]
        if p.same:
            return a, a
        b = np.array(b_pool, copy=True)
        b[i % b.shape[0]] = stamp[1]
        return a, b

    def call(self, i):
        a_vals, b_vals = self.values(i)
        with record_function("perfbench.execute"):
            return self.plans[self.product(i)].execute(a_vals, b_vals)

    def _release(self):
        for plan in self.plans.values():
            plan.release()
        self.plans = {}
