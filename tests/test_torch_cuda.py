"""The CUDA block-Gustavson kernel on the card, against its plain PyTorch
version. Needs no JAX, so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test is marked ``cuda`` and skips where no CUDA device is present
(a CUDA kernel has no CPU mode). Tolerances: 1e-5 for float32, 2e-2 for
bfloat16, the JAX package's own; bitwise with small-integer values, where
every float32 sum is exact whatever the order. The plain version runs on
the card with TF32 off, so its float32 products are full float32.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.gustavson import spgemm_gustavson
from repro_torch.core.schedule import build_spgemm_schedule
from repro_torch.kernels import ref
from repro_torch.kernels.gustavson_spgemm import (
    spgemm_scheduled,
    spgemm_scheduled_batch,
    stage_runs,
)
from repro_torch.sparse.convert import to_bcsr, to_bcsv
from repro_torch.sparse.formats import CSR
from repro_torch.sparse.random import random_block_sparse, suite_matrix
from repro_torch.spgemm import spgemm_plan

pytestmark = pytest.mark.cuda

SHAPES = [
    ((128, 128, 128), (32, 32, 32), 1),
    ((256, 128, 192), (64, 64, 64), 2),
    ((256, 384, 256), (64, 64, 128), 4),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield torch.device("cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _case(shape, blocks, group, seed, integer=False):
    m, k, n = shape
    bm, bk, bn = blocks
    ad = random_block_sparse(m, k, (bm, bk), 0.35, seed=seed)
    bd = random_block_sparse(k, n, (bk, bn), 0.4, seed=seed + 1)
    if integer:
        rng = np.random.default_rng(seed + 100)
        ad = np.where(ad != 0, rng.integers(1, 4, ad.shape), 0).astype(np.float32)
        bd = np.where(bd != 0, rng.integers(-3, 4, bd.shape), 0).astype(np.float32)
    a, b = to_bcsv(ad, (bm, bk), group), to_bcsr(bd, (bk, bn))
    return a, b, build_spgemm_schedule(a, b)


def _run_both(a, b, sch, dtype, device):
    at = torch.from_numpy(a.blocks).to(device, dtype)
    bt = torch.from_numpy(b.blocks).to(device, dtype)
    kernel = spgemm_scheduled(at, bt, stage_runs(sch, device))
    plain = ref.spgemm_scheduled_ref(at, bt, sch.a_slot, sch.b_slot, sch.panel,
                                     sch.sub_row, sch.n_panels, sch.group)
    torch.cuda.synchronize()
    return kernel.cpu(), plain.cpu()


@pytest.mark.parametrize("shape,blocks,group", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_vs_plain(cuda, shape, blocks, group, dtype):
    a, b, sch = _case(shape, blocks, group, seed=1)
    before = spgemm_scheduled.launches
    kernel, plain = _run_both(a, b, sch, dtype, cuda)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(kernel, plain, rtol=tol, atol=tol)
    assert spgemm_scheduled.launches == before + 1


@pytest.mark.parametrize("shape,blocks,group", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_small_integers_bitwise(cuda, shape, blocks, group, dtype):
    a, b, sch = _case(shape, blocks, group, seed=4, integer=True)
    kernel, plain = _run_both(a, b, sch, dtype, cuda)
    assert torch.equal(kernel, plain)


@pytest.mark.parametrize("shape,blocks,group", SHAPES)
def test_batch_equals_looped_single_bitwise(cuda, shape, blocks, group):
    a, b, sch = _case(shape, blocks, group, seed=7)
    runs = stage_runs(sch, cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    a_sets = torch.randn((3,) + a.blocks.shape, generator=g, device=cuda)
    b_sets = torch.randn((3,) + b.blocks.shape, generator=g, device=cuda)
    before = spgemm_scheduled_batch.launches
    batch = spgemm_scheduled_batch(a_sets.flatten(0, 1), b_sets.flatten(0, 1),
                                   runs, bsz=3)
    assert spgemm_scheduled_batch.launches == before + 1
    for i in range(3):
        assert torch.equal(batch[i], spgemm_scheduled(a_sets[i], b_sets[i], runs))


def test_kernel_rejects_unsupported_tiles(cuda):
    a, b, sch = _case((96, 96, 96), (24, 24, 24), 2, seed=3)
    at = torch.from_numpy(a.blocks).to(cuda)
    bt = torch.from_numpy(b.blocks).to(cuda)
    with pytest.raises(ValueError, match="multiples of 16"):
        spgemm_scheduled(at, bt, stage_runs(sch, cuda))


def test_plan_on_card_matches_cpu_plan_and_oracle(cuda):
    a = suite_matrix("poisson3Da", scale=0.05, seed=0)
    on_card = spgemm_plan(a, a, tile=64, group=4, device=cuda)
    on_cpu = spgemm_plan(a, a, tile=64, group=4, device="cpu")
    assert on_card.backend == "cuda" and on_cpu.backend == "torch"
    rng = np.random.default_rng(1)
    vals = rng.standard_normal((2, a.nnz)).astype(np.float32)
    got = on_card.execute(vals[0], vals[1])
    want = on_cpu.execute(vals[0], vals[1])
    assert np.array_equal(got.indptr, want.indptr)
    np.testing.assert_allclose(got.data, want.data, rtol=1e-5, atol=1e-5)
    batch = on_card.execute_batch(vals[None, 0], vals[None, 1])
    assert np.array_equal(batch[0].data, got.data)
    oracle = spgemm_gustavson(CSR(a.indptr, a.indices, vals[0], a.shape),
                              CSR(a.indptr, a.indices, vals[1], a.shape))
    np.testing.assert_allclose(got.todense(), oracle.todense(), rtol=1e-4, atol=1e-4)
    assert torch.equal(on_card.device_indptr().cpu(),
                       torch.from_numpy(got.indptr.astype(np.int32)))
