"""Port parity: the plain PyTorch version of the block-Gustavson kernel
against the JAX package's Pallas kernel (interpret mode) and its jnp
oracle, and the kernel wrappers' CPU path and input checks.

Tolerances are the JAX package's own (tests/test_kernels.py): 1e-5 for
float32, 2e-2 for bfloat16. With small-integer values every float32 sum is
exact, so there the results must agree bitwise. The CUDA kernel itself is
held against the same plain version in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.schedule import build_spgemm_schedule as r_build  # noqa: E402
from repro.kernels import ref as r_ref  # noqa: E402
from repro.kernels.gustavson_spgemm import (  # noqa: E402
    pad_schedule_arrays,
    spgemm_scheduled as r_spgemm_scheduled,
)
from repro.sparse.convert import to_bcsr as r_to_bcsr, to_bcsv as r_to_bcsv  # noqa: E402
from repro.sparse.random import random_block_sparse  # noqa: E402
from repro_torch.core.schedule import build_spgemm_schedule  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.gustavson_spgemm import (  # noqa: E402
    spgemm_scheduled,
    spgemm_scheduled_batch,
    stage_runs,
)
from repro_torch.sparse.convert import to_bcsr, to_bcsv  # noqa: E402

# The shapes of the JAX package's kernel sweep (tests/test_kernels.py).
SHAPES = [
    ((128, 128, 128), (32, 32, 32), 1),
    ((256, 128, 192), (64, 64, 64), 2),
    ((256, 384, 256), (64, 64, 128), 4),
]


def _operands(shape, blocks, group, seed=1, integer=False):
    """Dense block-sparse operands from a numpy seed, packed by both
    packages. ``integer`` swaps in small-integer values (exact sums)."""
    m, k, n = shape
    bm, bk, bn = blocks
    ad = random_block_sparse(m, k, (bm, bk), 0.35, seed=seed)
    bd = random_block_sparse(k, n, (bk, bn), 0.4, seed=seed + 1)
    if integer:
        rng = np.random.default_rng(seed + 100)
        ad = np.where(ad != 0, rng.integers(1, 4, ad.shape), 0).astype(np.float32)
        bd = np.where(bd != 0, rng.integers(-3, 4, bd.shape), 0).astype(np.float32)
    a, b = to_bcsv(ad, (bm, bk), group), to_bcsr(bd, (bk, bn))
    ra, rb = r_to_bcsv(ad, (bm, bk), group), r_to_bcsr(bd, (bk, bn))
    return a, b, ra, rb


def _jax_panels(ra, rb, dtype):
    """The Pallas kernel (interpret mode) and the jnp oracle, as numpy."""
    sch = r_build(ra, rb)
    padded = pad_schedule_arrays(sch.a_slot, sch.b_slot, sch.panel,
                                 sch.sub_row, sch.start, sch.n_panels)[:5]
    a = jnp.asarray(ra.blocks).astype(dtype)
    b = jnp.asarray(rb.blocks).astype(dtype)
    pallas = r_spgemm_scheduled(a, b, *map(jnp.asarray, padded),
                                n_panels=sch.n_panels, group=sch.group,
                                interpret=True)
    oracle = r_ref.spgemm_scheduled_ref(a, b, sch.a_slot, sch.b_slot, sch.panel,
                                        sch.sub_row, sch.n_panels, sch.group)
    return np.asarray(pallas), np.asarray(oracle)


def _plain(a, b, dtype):
    sch = build_spgemm_schedule(a, b)
    out = ref.spgemm_scheduled_ref(
        torch.from_numpy(a.blocks).to(dtype), torch.from_numpy(b.blocks).to(dtype),
        sch.a_slot, sch.b_slot, sch.panel, sch.sub_row, sch.n_panels, sch.group)
    return out.numpy()


@pytest.mark.parametrize("shape,blocks,group", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_vs_pallas_and_jnp(shape, blocks, group, dtype):
    a, b, ra, rb = _operands(shape, blocks, group)
    pallas, oracle = _jax_panels(ra, rb, getattr(jnp, dtype))
    got = _plain(a, b, getattr(torch, dtype))
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert got.dtype == np.float32 and got.shape == pallas.shape
    np.testing.assert_allclose(got, pallas, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, oracle, rtol=tol, atol=tol)


@pytest.mark.parametrize("shape,blocks,group", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_small_integers_bitwise(shape, blocks, group, dtype):
    a, b, ra, rb = _operands(shape, blocks, group, seed=4, integer=True)
    pallas, oracle = _jax_panels(ra, rb, getattr(jnp, dtype))
    got = _plain(a, b, getattr(torch, dtype))
    assert np.array_equal(got, pallas) and np.array_equal(got, oracle)


@pytest.mark.parametrize("shape,blocks,group", SHAPES)
def test_wrappers_cpu_path(shape, blocks, group):
    """On CPU tensors the wrappers compute the plain version; the batch
    wrapper equals a loop of single calls bitwise; nothing is launched."""
    a, b, _, _ = _operands(shape, blocks, group, seed=7)
    sch = build_spgemm_schedule(a, b)
    runs = stage_runs(sch, "cpu")
    at, bt = torch.from_numpy(a.blocks), torch.from_numpy(b.blocks)
    launches = (spgemm_scheduled.launches, spgemm_scheduled_batch.launches)
    single = spgemm_scheduled(at, bt, runs)
    assert torch.equal(single, ref.spgemm_scheduled_ref(
        at, bt, sch.a_slot, sch.b_slot, sch.panel, sch.sub_row,
        sch.n_panels, sch.group))
    rng = np.random.default_rng(3)
    sets = [(torch.from_numpy(rng.standard_normal(a.blocks.shape, np.float32)),
             torch.from_numpy(rng.standard_normal(b.blocks.shape, np.float32)))
            for _ in range(3)]
    batch = spgemm_scheduled_batch(torch.cat([s[0] for s in sets]),
                                   torch.cat([s[1] for s in sets]), runs, bsz=3)
    assert batch.shape == (3,) + tuple(single.shape)
    for i, (ai, bi) in enumerate(sets):
        assert torch.equal(batch[i], spgemm_scheduled(ai, bi, runs))
    assert (spgemm_scheduled.launches, spgemm_scheduled_batch.launches) == launches


def test_stage_runs_layout():
    a, b, _, _ = _operands(*SHAPES[2], seed=9)
    sch = build_spgemm_schedule(a, b)
    runs = stage_runs(sch, "cpu")
    assert all(t.dtype == torch.int32 for t in
               (runs.ptr, runs.a_slot, runs.b_slot, runs.panel, runs.sub_row))
    assert runs.a_slot.shape[0] == sch.num_triples
    assert runs.ptr.shape[0] == sch.n_panels * sch.group + 1
    tile = runs.panel.long() * sch.group + runs.sub_row.long()
    assert torch.all(tile[1:] >= tile[:-1])


def test_wrappers_reject_bad_inputs():
    a, b, _, _ = _operands(*SHAPES[1], seed=2)
    runs = stage_runs(build_spgemm_schedule(a, b), "cpu")
    at, bt = torch.from_numpy(a.blocks), torch.from_numpy(b.blocks)
    with pytest.raises(TypeError):
        spgemm_scheduled(at.double(), bt.double(), runs)
    with pytest.raises(TypeError):
        spgemm_scheduled(at, bt.bfloat16(), runs)
    with pytest.raises(ValueError):
        spgemm_scheduled(at, bt.transpose(1, 2), runs)
    with pytest.raises(ValueError):
        spgemm_scheduled(at.transpose(1, 2).contiguous().transpose(1, 2), bt, runs)
    with pytest.raises(ValueError):
        spgemm_scheduled_batch(at, bt, runs, bsz=at.shape[0] + 1)
    with pytest.raises(TypeError):
        spgemm_scheduled(a.blocks, b.blocks, runs)
