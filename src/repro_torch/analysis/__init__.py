"""Static analysis over SpGEMM plans, the K1/K2 launch, and concurrency.

The port of the JAX package's ``analysis/``. The plan/execute stack's
correctness rests on invariants that the tests only witness indirectly
(bitwise end-to-end equality). This package checks them *statically*: no
numeric execution, no kernel launch.

* :mod:`repro_torch.analysis.verify` — :func:`~repro_torch.analysis.verify.verify_plan`:
  schedule well-formedness, dummy-pad-panel write-only discipline,
  assembly coverage (every structural C nnz gathered exactly once),
  write-write race freedom of the batch-folded and stacked-shard streams
  and of the CUDA launch over the staged schedule runs, shard-partition
  exactness, compact-map exactness.
* :mod:`repro_torch.analysis.kernel_lint` — the Hopper twin of the JAX
  package's ``pallas_call`` spec lint: K1/K2's launch geometry, the run
  indices with batch offsets in bounds, float32 accumulation, and the
  dynamic shared memory against the device's opt-in limit.
* :mod:`repro_torch.analysis.locks` — instrumented lock wrappers recording
  the lock-acquisition graph of the serving stack (gateway, pipeline,
  cache, plan, persist) and failing on cycles.
* :mod:`repro_torch.analysis.check` — the CLI:
  ``python -m repro_torch.analysis.check --paper-matrices [--shards N]``.

Opt-in deep validation is wired into the plan API as
``spgemm_plan(..., validate="deep")``: fresh builds and cache hits are
verified before they are returned, and disk rehydrates are verified
*inside* the loader, so a corrupted-but-digest-valid artifact fails
verification (and falls back to a clean symbolic rebuild) instead of
reaching the kernel.
"""
from repro_torch.analysis.verify import (
    Finding,
    PlanVerificationError,
    VerifyReport,
    verify_plan,
)
from repro_torch.analysis.kernel_lint import lint_kernel_module, lint_plan_kernel_specs
from repro_torch.analysis.locks import LockOrderMonitor, instrument_spgemm_locks

__all__ = [
    "Finding",
    "LockOrderMonitor",
    "PlanVerificationError",
    "VerifyReport",
    "instrument_spgemm_locks",
    "lint_kernel_module",
    "lint_plan_kernel_specs",
    "verify_plan",
]
