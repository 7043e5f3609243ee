"""Triangle counting via a device-resident SpGEMM chain.

The classic A²-based count: for an undirected graph with adjacency A,
``tri(v) = (A² ∘ A)[v] / 2`` — the number of triangles through vertex v
is half the number of 2-paths v→x→v' that are closed by an edge. Total
triangles = ``trace-free sum / 6`` == ``sum(A² ∘ A) / 6``.

The chaining layer makes the SpGEMM side one plan composition:
``output="compact"`` keeps A² element-exact (no block-padding zeros),
and the Hadamard mask with A only needs A²'s entries *at A's own
pattern* — which is exactly what ``plan_from_structural_pattern``
computes structurally. Both products run through K1 on the card
(``--device cuda``, the default); the chain's second stage binds the
first stage's values on the device, with no host round trip.

    PYTHONPATH=src python examples_torch/spgemm_chain.py [--matrix poisson3Da]
    PYTHONPATH=src python examples_torch/spgemm_chain.py --device cpu --scale 0.01
"""
import argparse

import numpy as np

from repro_torch.sparse.formats import COO
from repro_torch.sparse.random import suite_matrix
from repro_torch.spgemm import PlanCache, spgemm_plan


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--matrix", default="poisson3Da")
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # 1. An undirected, loop-free 0/1 adjacency with the paper matrix's
    #    sparsity profile.
    m = suite_matrix(args.matrix, scale=args.scale).to_coo().sum_duplicates()
    n = m.shape[0]
    keep = m.row != m.col
    row = np.concatenate([m.row[keep], m.col[keep]])
    col = np.concatenate([m.col[keep], m.row[keep]])
    adj = COO(row, col, np.ones(row.size, np.float32), (n, n))
    adj = adj.sum_duplicates()
    adj.val = np.ones(adj.nnz, np.float32)  # dedupe may have summed
    print(f"graph: {n} vertices, {adj.nnz} directed edges")

    # 2. Plan A @ A with compacted (nnz-exact) output. The compact CSR is
    #    the structural square — no block-padding zeros to mask out.
    cache = PlanCache()
    p = spgemm_plan(adj, adj, tile=16, group=2, device=args.device, cache=cache,
                    output="compact")
    a2 = p.execute()
    print(f"A²: {a2.data.size} structural entries "
          f"(block output would store {p.assembly.nnz})")

    # 3. Chain demo: A² @ A = A³ without a host round trip — its diagonal
    #    is 2·tri(v) per vertex, so trace(A³)/6 is the triangle count.
    chain = p.then(adj, cache=cache)
    a3 = chain.execute()
    d3 = a3.todense()
    tri_trace = float(np.trace(d3)) / 6.0

    # 4. Same count via the Hadamard route on A² (mask by A's pattern).
    d2 = a2.todense()
    da = np.zeros((n, n), np.float32)
    da[adj.row, adj.col] = 1.0
    tri_hadamard = float((d2 * da).sum()) / 6.0

    # 5. Dense oracle.
    ref = float(np.trace(da @ da @ da)) / 6.0
    print(f"triangles: chain trace(A³)/6 = {tri_trace:.0f}, "
          f"Hadamard sum(A²∘A)/6 = {tri_hadamard:.0f}, oracle = {ref:.0f}")
    assert tri_trace == tri_hadamard == ref
    print("OK")


if __name__ == "__main__":
    main()
