"""The CUDA kernels on the card, against their plain PyTorch versions:
block-Gustavson SpGEMM (K1, K2, and their 1 x 1 x 1 specialization of
``output="exact"`` plans, within one float32 ulp of its plain version and
bitwise equal to K1 at tile 16; a plan's block assembly map built on the
card, bitwise the host's; also through the asynchronous pipeline,
on side streams, a device-resident chain, a sharded plan of four shards on
one card, a plan rehydrated from the disk tier, the autotuner's probes and
the serving gateway; the probe timer's device wait), flash attention (K5,
also at prefill lengths that are not multiples of 512), the block-sparse
SpMM (K3) and the grouped expert matmul (K4), the LM forwards through
K5 and K4 (the eight architectures beyond granite and qwen3 too: their
head widths, MQA, their expert widths, their reduced forwards), and
training: the attention VJP (K5 forward, plain recompute
backward), K3 and K4 refusing CUDA operands that require grad at their
``ops`` entry points, the MoE layer's expert matmul whose backward is two
more K4 launches (also under remat), and train steps of the reduced
granite through K5 and of the reduced qwen3 through K5 and K4. Needs no JAX, so it runs on a
machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test is marked ``cuda`` and skips where no CUDA device is present
(a CUDA kernel has no CPU mode). Tolerances are the JAX package's own:
1e-5 for float32 and 2e-2 for bfloat16 SpGEMM, bitwise with small-integer
values (where every float32 sum is exact whatever the order); 2e-4 for
float32 attention. Bfloat16 attention is held at rtol 1e-2, atol 1e-3:
the plain version computes in float32; the kernel's tensor cores form
exact float32 products of the bf16 inputs, carry P to ~2**-17 (two bf16
halves) and round the output to bfloat16 (at most 2**-8 of it), while the
JAX package's 5e-2 is as large as a typical |output| at these shapes and
could not fail a wrong kernel. K3 and K4 write float32 sums of
float32 products of the same inputs as their plain versions, in float32
and in bfloat16 alike (their bfloat16 kernels run on wgmma, whose bf16
products are exact in float32), so both are held at the JAX package's
float32 tolerances (1e-3 for K3, 1e-4 for K4; inputs scaled so outputs are
of order 1 to 10). The plain versions run on the card with TF32 off, so
their float32 products are full float32.
"""
import numpy as np
import pytest
import torch

import copy

from repro_torch.configs.registry import get_reduced
from repro_torch.core.gustavson import spgemm_gustavson
from repro_torch.core.schedule import build_exact_schedule, build_spgemm_schedule
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bsr_spmm import bsr_spmm, bsr_spmm_staged, stage_bsr_index
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.moe_gmm import moe_gmm
from repro_torch.kernels.gustavson_spgemm import (
    runs_case,
    spgemm_scheduled,
    spgemm_scheduled_batch,
    stage_runs,
)
from repro_torch.sparse.convert import to_bcsr, to_bcsv
from repro_torch.sparse.formats import COO, CSR
from repro_torch.sparse.random import random_block_sparse, suite_matrix
from repro_torch.models import transformer as tr
from repro_torch.spgemm import spgemm_plan

pytestmark = pytest.mark.cuda

SHAPES = [
    ((128, 128, 128), (32, 32, 32), 1),
    ((256, 128, 192), (64, 64, 64), 2),
    ((256, 384, 256), (64, 64, 128), 4),
    ((256, 512, 256), (128, 128, 128), 2),
]
# Tiles of the run-length cases: the JAX package's three and a 128^3 tile.
RUN_TILES = [(32, 32, 32), (64, 64, 64), (64, 64, 128), (128, 128, 128)]


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


@pytest.mark.parametrize("tile", RUN_TILES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("integer", [False, True])
def test_kernel_runs_of_0_1_3_8_triples(cuda, tile, dtype, integer):
    """Tiles whose runs hold 0, 1, 3 and 8 triples (the ring's prologue
    longer than, equal to and shorter than the run): K1 against its plain
    version (bitwise on small integers), the empty tile zero, and K2 over
    three value sets bitwise equal to looped K1."""
    a, b, sch = runs_case(tile, integer)
    runs = stage_runs(sch, cuda)
    assert np.diff(runs.ptr.cpu().numpy()).tolist() == [0, 1, 3, 8]
    kernel, plain = _run_both(a, b, sch, dtype, cuda)
    bm = tile[0]
    assert torch.all(kernel[0, :bm] == 0)
    if integer:
        assert torch.equal(kernel, plain)
    else:
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(kernel, plain, rtol=tol, atol=tol)
    g = torch.Generator(device=cuda).manual_seed(3)
    a_sets = torch.randn((3,) + a.blocks.shape, generator=g, device=cuda).to(dtype)
    b_sets = torch.randn((3,) + b.blocks.shape, generator=g, device=cuda).to(dtype)
    before = spgemm_scheduled_batch.bf16_launches
    batch = spgemm_scheduled_batch(a_sets.flatten(0, 1), b_sets.flatten(0, 1), runs, bsz=3)
    assert spgemm_scheduled_batch.bf16_launches == before + (dtype == torch.bfloat16)
    for i in range(3):
        assert torch.equal(batch[i], spgemm_scheduled(a_sets[i], b_sets[i], runs))


def test_kernel_rejects_unsupported_tiles(cuda):
    a, b, sch = _case((96, 96, 96), (24, 24, 24), 2, seed=3)
    at = torch.from_numpy(a.blocks).to(cuda)
    bt = torch.from_numpy(b.blocks).to(cuda)
    with pytest.raises(ValueError, match="multiples of 16"):
        spgemm_scheduled(at, bt, stage_runs(sch, cuda))


def _element_case(structure, m, k, n, seed):
    """Operands of an element (tile 1) schedule, as canonical COOs."""
    from repro_torch.sparse.random import random_coo

    a = random_coo(m, k, 12.0 / k, structure, seed=seed)
    b = random_coo(k, n, 12.0 / n, structure, seed=seed + 1)
    return a, b, build_exact_schedule(a.row, a.col, b.row, b.col, a.shape, b.shape)


def _within_one_ulp(got: torch.Tensor, want: torch.Tensor) -> bool:
    up = torch.nextafter(want, torch.full_like(want, float("inf")))
    down = torch.nextafter(want, torch.full_like(want, float("-inf")))
    return bool(((got == want) | (got == up) | (got == down)).all())


@pytest.mark.parametrize("structure", ["graph", "fem", "circuit"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_element_kernel_within_one_ulp_of_plain(cuda, structure, dtype):
    """K1's 1 x 1 x 1 specialization (one thread per entry) against its
    plain version on the CPU, which sums each entry's pairs in run order
    rounding once per step: within one float32 ulp entry by entry; one
    launch counted."""
    a, b, sch = _element_case(structure, 3000, 2500, 2800, seed=3)
    rng = np.random.default_rng(4)
    av = torch.from_numpy(rng.standard_normal((a.nnz, 1, 1), dtype=np.float32)).to(dtype)
    bv = torch.from_numpy(rng.standard_normal((b.nnz, 1, 1), dtype=np.float32)).to(dtype)
    before = spgemm_scheduled.launches
    kernel = spgemm_scheduled(av.to(cuda), bv.to(cuda), stage_runs(sch, cuda)).cpu()
    assert spgemm_scheduled.launches == before + 1
    plain = spgemm_scheduled(av, bv, stage_runs(sch, "cpu"))
    assert kernel.shape == plain.shape == (sch.n_panels, 1, 1)
    assert _within_one_ulp(kernel, plain)


def test_element_kernel_batch_equals_looped_single_bitwise(cuda):
    """The batched form over three value sets equals three single launches
    bit for bit, counted once in ``spgemm_scheduled_batch.launches``."""
    a, b, sch = _element_case("graph", 2000, 2000, 2000, seed=5)
    runs = stage_runs(sch, cuda)
    g = torch.Generator(device=cuda).manual_seed(6)
    a_sets = torch.randn((3, a.nnz, 1, 1), generator=g, device=cuda)
    b_sets = torch.randn((3, b.nnz, 1, 1), generator=g, device=cuda)
    before = spgemm_scheduled_batch.launches
    batch = spgemm_scheduled_batch(a_sets.flatten(0, 1), b_sets.flatten(0, 1), runs, bsz=3)
    assert spgemm_scheduled_batch.launches == before + 1
    assert batch.shape == (3, sch.n_panels, 1, 1)
    for i in range(3):
        assert torch.equal(batch[i], spgemm_scheduled(a_sets[i], b_sets[i], runs))


def test_exact_plan_on_card(cuda):
    """An ``output="exact"`` plan on the card: each ``execute`` launches K1
    once; C equals the compact plan's at tile 16 bit for bit (K1's ring at
    16^3 sums the same FMA chain, its block fill adding exact zeros), is
    within one ulp of the exact plan on the CPU and within 1e-5 of the
    oracle; ``execute_batch`` and a depth-2 pipeline equal ``execute``
    bitwise; a rectangular A·B too."""
    from repro_torch.spgemm import PlanCache

    for m, k, n in ((4000, 4000, 4000), (1500, 2200, 900)):
        a, b, _ = _element_case("graph", m, k, n, seed=7)
        plan = spgemm_plan(a, b, tile=1, group=1, output="exact", device=cuda,
                           cache=PlanCache())
        block = spgemm_plan(a, b, tile=16, group=1, output="compact", device=cuda,
                            cache=PlanCache())
        cpu = spgemm_plan(a, b, tile=1, group=1, output="exact", device="cpu",
                          cache=PlanCache())
        rng = np.random.default_rng(8)
        av = rng.standard_normal((3, a.nnz)).astype(np.float32)
        bv = rng.standard_normal((3, b.nnz)).astype(np.float32)
        before = spgemm_scheduled.launches
        got = [plan.execute(av[i], bv[i]) for i in range(3)]
        assert spgemm_scheduled.launches == before + 3
        want = block.execute(av[0], bv[0])
        assert np.array_equal(got[0].indptr, want.indptr)
        assert np.array_equal(got[0].indices, want.indices)
        assert np.array_equal(got[0].data, want.data)
        assert _within_one_ulp(torch.from_numpy(got[0].data),
                               torch.from_numpy(cpu.execute(av[0], bv[0]).data))
        oracle = spgemm_gustavson(CSR.from_coo(COO(a.row, a.col, av[0], a.shape)),
                                  CSR.from_coo(COO(b.row, b.col, bv[0], b.shape)))
        np.testing.assert_allclose(got[0].todense(), oracle.todense(), rtol=1e-5, atol=1e-5)
        for g, w in zip(plan.execute_batch(av, bv), got):
            assert np.array_equal(g.data, w.data)
        with plan.pipeline(depth=2) as pipe:
            piped = list(pipe.stream((av[i], bv[i]) for i in range(3)))
        for g, w in zip(piped, got):
            assert np.array_equal(g.data, w.data)


def test_bf16_plan_on_card_launches_bf16_blocks(cuda):
    """A plan built on bfloat16 values (a bfloat16 sparse CSR tensor)
    stages bfloat16 blocks: ``execute`` launches K1 once with them, and
    agrees with the same plan on the CPU (float32 sums of the same
    bf16-rounded products) within 1e-5 and with the oracle on the rounded
    values within 1e-4; ``execute_batch`` equals looped ``execute``."""
    a = suite_matrix("poisson3Da", scale=0.05, seed=0)
    t = torch.sparse_csr_tensor(torch.from_numpy(a.indptr.astype(np.int64)),
                                torch.from_numpy(a.indices.astype(np.int64)),
                                torch.from_numpy(a.data.astype(np.float32)).bfloat16(), a.shape)
    on_card = spgemm_plan(t, t, tile=64, group=4, device=cuda)
    on_cpu = spgemm_plan(t, t, tile=64, group=4, device="cpu")
    assert on_card.value_dtypes == (torch.bfloat16, torch.bfloat16)
    rng = np.random.default_rng(2)
    vals = rng.standard_normal((2, a.nnz)).astype(np.float32)
    before = (spgemm_scheduled.launches, spgemm_scheduled.bf16_launches)
    got = on_card.execute(vals[0], vals[1])
    assert (spgemm_scheduled.launches, spgemm_scheduled.bf16_launches) == (
        before[0] + 1, before[1] + 1)
    want = on_cpu.execute(vals[0], vals[1])
    np.testing.assert_allclose(got.data, want.data, rtol=1e-5, atol=1e-5)
    rounded = torch.from_numpy(vals).bfloat16().float().numpy()
    oracle = spgemm_gustavson(CSR(a.indptr, a.indices, rounded[0], a.shape),
                              CSR(a.indptr, a.indices, rounded[1], a.shape))
    np.testing.assert_allclose(got.todense(), oracle.todense(), rtol=1e-4, atol=1e-4)
    batch = on_card.execute_batch(vals[None, 0], vals[None, 1])
    assert np.array_equal(batch[0].data, got.data)


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


def test_execute_downloads_into_page_locked_memory(cuda):
    """The synchronous surfaces copy C into a fresh page-locked tensor:
    ``spgemm.d2h_pinned_bytes`` moves by C's bytes, as ``spgemm.d2h_bytes``
    does; the values are bitwise those of a plain ``.cpu()`` of the same
    packed tensor; a result keeps its values after later requests and
    shares no memory with them."""
    from repro_torch.runtime.heartbeat import default_registry
    from repro_torch.spgemm import execute_chain

    reg = default_registry()
    a = suite_matrix("poisson3Da", scale=0.05, seed=0)
    plan = spgemm_plan(a, a, tile=64, group=4, device=cuda)
    rng = np.random.default_rng(3)
    vals = rng.standard_normal((3, 2, a.nnz)).astype(np.float32)
    pinned, d2h = reg.counter("spgemm.d2h_pinned_bytes").value, reg.counter("spgemm.d2h_bytes").value
    packed = plan._run_packed(vals[0, 0], vals[0, 1])
    c = plan._wrap_packed(packed)
    assert reg.counter("spgemm.d2h_pinned_bytes").value - pinned == c.data.nbytes > 0
    assert reg.counter("spgemm.d2h_bytes").value - d2h == c.data.nbytes
    assert torch.from_numpy(c.data).is_pinned()
    assert np.array_equal(c.data.view(np.uint32), packed.cpu().numpy().view(np.uint32))
    chain = plan.then(a)
    surfaces = [lambda v: plan.execute(v[0], v[1]),
                lambda v: plan.execute_batch(v[None, 0], v[None, 1])[0],
                lambda v: execute_chain(chain, v[0], v[1])]
    for run in surfaces:
        pinned, d2h = reg.counter("spgemm.d2h_pinned_bytes").value, reg.counter("spgemm.d2h_bytes").value
        first = run(vals[1])
        kept = first.data.copy()
        second = run(vals[2])
        assert torch.from_numpy(second.data).is_pinned()
        assert np.array_equal(first.data, kept)
        assert not np.shares_memory(first.data, second.data)
        moved = reg.counter("spgemm.d2h_pinned_bytes").value - pinned
        assert moved == reg.counter("spgemm.d2h_bytes").value - d2h == 2 * first.data.nbytes


@pytest.mark.parametrize("output", ["block", "compact"])
def test_plan_builds_its_block_map_on_the_card(cuda, output, monkeypatch):
    """On a fem14k-sized pattern (14,000², density 1.9e-3, class fem; the
    last block row and column overhang by 16) a CUDA plan builds its block
    assembly map on the card (``on_device`` 1 on its span): bitwise a CPU
    plan's map; the block plan's executor gathers through the very tensor
    ``assembly_map_on`` made, not a second upload, and under
    ``output="compact"`` through the compact map, unchanged; ``execute``
    equals bitwise a plan whose map was built on the host."""
    from repro_torch.runtime import heartbeat as hb
    from repro_torch.spgemm import PlanCache
    from repro_torch.spgemm import plan as plan_mod
    from repro_torch.sparse.random import random_coo

    a = random_coo(14_000, 14_000, 1.9e-3, structure="fem", seed=0)
    built, real = [], plan_mod.assembly_map_on

    def recording(*args):
        built.append(real(*args))
        return built[-1]

    monkeypatch.setattr(plan_mod, "assembly_map_on", recording)
    hb.set_tracing(True)
    hb.default_recorder().clear()
    try:
        on_card = spgemm_plan(a, a, tile=64, group=4, device=cuda, cache=PlanCache(),
                              output=output)
        counts = hb.totals()["spans"]["spgemm.plan.assembly"]["counts"]
    finally:
        hb.set_tracing(False)
        hb.default_recorder().clear()
    assert counts == {"on_device": 1} and len(built) == 1
    on_cpu = spgemm_plan(a, a, tile=64, group=4, device="cpu", cache=PlanCache(),
                         output=output)
    for f in ("gather", "indptr", "indices"):
        got, want = getattr(on_card.assembly, f), getattr(on_cpu.assembly, f)
        assert got.dtype == want.dtype and np.array_equal(got, want), f
        assert torch.from_numpy(got).is_pinned(), f
    assert on_card.assembly.shape == on_cpu.assembly.shape == (14_000, 14_000)
    assert 14_000 % 64 and on_card.assembly.nnz > 8_000_000
    gather = on_card._executor._gather
    if output == "block":
        assert gather is built[0].gather
    else:
        for f in ("gather", "indptr", "indices"):
            assert np.array_equal(getattr(on_card.compact, f), getattr(on_cpu.compact, f)), f
        assert gather is not built[0].gather
        assert torch.equal(gather.cpu(), torch.from_numpy(on_card.compact.gather))
    monkeypatch.setattr(plan_mod.SpGEMMPlan, "_assembles_on_device", False)
    on_host = spgemm_plan(a, a, tile=64, group=4, device=cuda, cache=PlanCache(),
                          output=output)
    assert len(built) == 1
    vals = np.random.default_rng(11).standard_normal(a.nnz).astype(np.float32)
    got, want = on_card.execute(vals, vals), on_host.execute(vals, vals)
    assert np.array_equal(got.indptr, want.indptr) and np.array_equal(got.indices, want.indices)
    assert np.array_equal(got.data.view(np.uint32), want.data.view(np.uint32))


def _submit_without_sync(pipe, *vals):
    """``submit`` with PyTorch's sync debug mode set to raise: any hidden
    synchronization (a pageable copy, ``.item()``) fails the call."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return pipe.submit(*vals)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_pipeline_on_card_bitwise_equals_execute(cuda, depth):
    """Pipelined steps on the card equal sequential ``execute`` bitwise
    (element and batched submits), every ``submit`` runs without a
    synchronization, K1 runs on one side stream per slot, and a collected
    result is not overwritten by the steps submitted after it."""
    from repro_torch.data.pipeline import SpGEMMValueStream

    a = suite_matrix("poisson3Da", scale=0.05, seed=0)
    plan = spgemm_plan(a, a, tile=64, group=4, device=cuda)
    stream = SpGEMMValueStream(plan.a_pattern, plan.b_pattern, seed=3)
    sets = [stream.values_at(s) for s in range(2 * depth + 2)]
    seq = [plan.execute(*v) for v in sets]
    spgemm_scheduled.stream_launches.clear()
    out = []
    with plan.pipeline(depth=depth) as pipe:
        for v in sets:
            if pipe.free_slots == 0:
                out.append(pipe.collect())
            _submit_without_sync(pipe, *v)
        kept = out[0].data.copy() if out else None
        out.extend(pipe)
    assert len(out) == len(seq)
    for got, want in zip(out, seq):
        assert np.array_equal(got.data, want.data)
    if kept is not None:
        assert np.array_equal(out[0].data, kept)
    default = torch.cuda.default_stream(cuda).cuda_stream
    side = set(spgemm_scheduled.stream_launches) - {default}
    assert len(side) == depth and sum(spgemm_scheduled.stream_launches.values()) == len(sets)
    av, bv = stream.values_batch_at(0, batch=3)
    with plan.pipeline(depth=depth) as pipe:
        got = _submit_without_sync(pipe, av, bv).result()
    for g, w in zip(got, plan.execute_batch(av, bv)):
        assert np.array_equal(g.data, w.data)
    assert plan.in_flight == 0


def test_chain_on_card_keeps_intermediates_on_the_device(cuda):
    """A compact chain's intermediates are CUDA tensors, and the chain
    equals its stages with a host round trip between them, bitwise."""
    a = suite_matrix("poisson3Da", scale=0.05, seed=0)
    rng = np.random.default_rng(4)
    a = CSR(a.indptr, a.indices, rng.integers(-4, 5, a.nnz).astype(np.float32), a.shape)
    b2 = suite_matrix("poisson3Da", scale=0.05, seed=1)
    chain = spgemm_plan(a, a, tile=64, group=4, device=cuda, output="compact").then(b2)
    packed = chain.plans[0]._run_packed()
    assert packed.is_cuda
    assert chain.plans[1]._run_packed_chained(packed).is_cuda
    out = chain.execute()
    stage1 = chain.plans[0].execute()
    assert np.array_equal(out.data, chain.plans[1].execute(a_vals=stage1.data).data)
    compact, block = chain.plans[0], spgemm_plan(a, a, tile=64, group=4, device=cuda)
    assert np.array_equal(stage1.todense(), block.execute().todense())
    assert torch.equal(compact.device_indptr().cpu(),
                       torch.from_numpy(stage1.indptr.astype(np.int32)))


def test_an_exact_chain_binds_values_from_the_card_on_the_card(cuda):
    """The Galerkin product's request: an exact chain handed stage 1's B
    values as a CUDA tensor copies nothing host to device, keeps no host
    copy of them (its device copy is a clone, not the caller's buffer),
    launches the element kernel once per stage and equals the same values
    handed over from the host, bitwise. Numpy values still take the host
    path. ``release_device_values`` copies them back once, and the next
    no-arg run gives the same C."""
    from repro_torch.runtime.heartbeat import default_registry
    from repro_torch.sparse.random import random_coo
    from repro_torch.spgemm import PlanCache, execute_chain

    r, a = random_coo(200, 300, 0.02, seed=60), random_coo(300, 300, 0.03, "fem", seed=61)
    p = random_coo(300, 180, 0.02, seed=62)
    chain = spgemm_plan(r, a, tile=1, group=1, output="exact", device=cuda,
                        cache=PlanCache()).then(p, cache=PlanCache())
    chain.execute()  # R and P on the card
    stage1 = chain.plans[0]
    av = np.random.default_rng(63).standard_normal(a.nnz).astype(np.float32)
    dev = torch.from_numpy(av).to(cuda)
    h2d = default_registry().counter("spgemm.h2d_bytes")
    before, launches = h2d.value, spgemm_scheduled.launches
    got = execute_chain(chain, b_vals=dev)
    assert h2d.value == before and spgemm_scheduled.launches == launches + 2
    assert stage1._b_host is None and stage1._b_dev.is_cuda
    assert stage1._b_dev.data_ptr() != dev.data_ptr()
    dev.zero_()
    assert np.array_equal(chain.execute().data, got.data)
    want = execute_chain(chain, b_vals=av)
    assert h2d.value == before + av.nbytes and stage1._b_host is not None
    assert np.array_equal(got.data, want.data)
    execute_chain(chain, b_vals=torch.from_numpy(av).to(cuda))
    stage1.release_device_values()
    assert stage1._b_dev is None and stage1._b_host is not None
    assert np.array_equal(stage1._b_host.numpy(), av)
    assert np.array_equal(chain.execute().data, want.data)


def test_sharded_plan_on_card_bitwise_equals_single(cuda):
    """Four shards on cuda:0 (a mesh that repeats the card): ``execute``,
    ``execute_batch(4)``, compact output and a depth-2 pipeline equal the
    single-device plan bitwise on random float32 values, and K1 (K2 for a
    batch chunk) is launched once per launching shard."""
    from repro_torch.launch.mesh import make_shard_mesh
    from repro_torch.spgemm import PlanCache

    a = suite_matrix("poisson3Da", scale=0.05, seed=0)
    mesh = make_shard_mesh(4, devices=[cuda] * 4)
    rng = np.random.default_rng(5)
    vals = rng.standard_normal((4, 2, a.nnz)).astype(np.float32)
    for output in ("block", "compact"):
        single = spgemm_plan(a, a, tile=64, group=4, device=cuda, cache=PlanCache(),
                             output=output)
        plan = spgemm_plan(a, a, tile=64, group=4, device=cuda, cache=PlanCache(),
                           output=output, mesh=mesh)
        n = plan._executor.n_launching
        assert n == sum(t > 0 for t in plan.shard_stats()["triples"]) > 1
        want = single.execute(vals[0, 0], vals[0, 1])
        before = spgemm_scheduled.launches
        got = plan.execute(vals[0, 0], vals[0, 1])
        torch.cuda.synchronize()
        assert spgemm_scheduled.launches == before + n
        assert np.array_equal(got.indptr, want.indptr) and np.array_equal(got.data, want.data)
        batch_want = single.execute_batch(vals[:, 0], vals[:, 1])
        chunk = min(4, plan._executor.batch_chunk())
        before = spgemm_scheduled_batch.launches
        batch = plan.execute_batch(vals[:, 0], vals[:, 1])
        torch.cuda.synchronize()
        assert spgemm_scheduled_batch.launches == before + n * -(-4 // chunk)
        for g, w in zip(batch, batch_want):
            assert np.array_equal(g.data, w.data)
        with plan.pipeline(depth=2) as pipe:
            piped = list(pipe.stream((vals[i, 0], vals[i, 1]) for i in range(4)))
        for g, w in zip(piped, batch_want):
            assert np.array_equal(g.data, w.data)
        assert torch.equal(plan.device_indptr().cpu(),
                           torch.from_numpy(want.indptr.astype(np.int32)))


def test_disk_rehydrate_on_card_bitwise_equals_cold(cuda, tmp_path):
    """A plan written to the disk tier and rehydrated by a fresh cache
    runs no symbolic phase, launches K1, and executes bitwise equal to
    the cold plan."""
    from repro_torch.spgemm import PlanCache, schedule_build_count

    a = suite_matrix("poisson3Da", scale=0.05, seed=0)
    coo = a.to_coo()  # the token's disk path rebinds COO operands
    cold = spgemm_plan(coo, coo, tile=64, group=4, device=cuda,
                       cache=PlanCache(disk_dir=str(tmp_path)), pattern_token="p3da")
    builds = schedule_build_count()
    cache = PlanCache(disk_dir=str(tmp_path))
    warm = spgemm_plan(coo, coo, tile=64, group=4, device=cuda, cache=cache,
                       pattern_token="p3da")
    assert schedule_build_count() == builds and warm.report.loads == 1
    assert cache.stats.token_disk_hits == 1
    vals = np.random.default_rng(6).standard_normal((2, a.nnz)).astype(np.float32)
    want = cold.execute(vals[0], vals[1])
    before = spgemm_scheduled.launches
    got = warm.execute(vals[0], vals[1])
    torch.cuda.synchronize()
    assert spgemm_scheduled.launches == before + 1
    assert np.array_equal(got.indices, want.indices) and np.array_equal(got.data, want.data)


def test_smem_mirror_equals_the_librarys_export(cuda):
    """The launch lint's Python mirror of K1's dynamic shared memory and
    threads equals what the library exports, over every tile it takes
    ({16..128}^3 in steps of 16) and both block dtypes, and every such
    launch lints clean against this device's opt-in limit."""
    from repro_torch.analysis.kernel_lint import (
        device_smem_limit, k1_smem_bytes, k1_threads, lint_launch_config)
    from repro_torch.kernels._build import load_gustavson

    lib = load_gustavson()
    limit = device_smem_limit(cuda)
    dims = range(16, 129, 16)
    for code, dtype in ((0, torch.float32), (1, torch.bfloat16)):
        for tile in [(m, k, n) for m in dims for k in dims for n in dims]:
            assert lib.gustavson_spgemm_smem_bytes(code, *tile) == k1_smem_bytes(dtype, *tile)
            assert lib.gustavson_spgemm_threads(code, *tile) == k1_threads(*tile)
            assert lint_launch_config(tile, dtype, smem_limit=limit) == []
        assert lib.gustavson_spgemm_smem_bytes(code, 24, 16, 16) == 0


def test_deep_validated_plans_on_card(cuda, tmp_path):
    """``validate="deep"`` on the card: the verifier proves the launch over
    the runs staged on the device, the plan runs K1 against the oracle; a
    digest-valid artifact whose A slot points past A is rejected inside
    the loader and rebuilt, with no launch, bitwise equal to the cold
    plan."""
    import glob
    import json
    import os

    from repro_torch.analysis.kernel_lint import lint_plan_kernel_specs
    from repro_torch.analysis.verify import verify_plan
    from repro_torch.spgemm import PlanCache
    from repro_torch.spgemm.persist import _META_KEY, _payload_digest

    a = suite_matrix("poisson3Da", scale=0.05, seed=0)
    coo = a.to_coo()
    cold = spgemm_plan(coo, coo, tile=32, group=4, device=cuda,
                       cache=PlanCache(disk_dir=str(tmp_path)), validate="deep")
    assert cold._executor.staged_runs()[0].ptr.is_cuda
    assert verify_plan(cold).ok and lint_plan_kernel_specs(cold) == []
    vals = np.random.default_rng(8).standard_normal((2, a.nnz)).astype(np.float32)
    want = spgemm_gustavson(CSR(a.indptr, a.indices, vals[0], a.shape),
                            CSR(a.indptr, a.indices, vals[1], a.shape)).todense()
    np.testing.assert_allclose(cold.execute(vals[0], vals[1]).todense(), want,
                               rtol=1e-4, atol=1e-4)
    [path] = glob.glob(os.path.join(str(tmp_path), "*.plan-torch.npz"))
    with np.load(path, allow_pickle=False) as npz:
        arrays = {n: npz[n].copy() for n in npz.files if n != _META_KEY}
        header = json.loads(bytes(np.asarray(npz[_META_KEY])).decode())
    arrays["sched.a_slot"][0] = header["meta"]["a_shape"][0]
    header["digest"] = _payload_digest(arrays, header["meta"])
    with open(path, "wb") as f:
        np.savez(f, **arrays, **{_META_KEY: np.frombuffer(json.dumps(header).encode(), np.uint8)})
    before = spgemm_scheduled.launches
    cache = PlanCache(disk_dir=str(tmp_path))
    plan = spgemm_plan(coo, coo, tile=32, group=4, device=cuda, cache=cache, validate="deep")
    torch.cuda.synchronize()
    assert spgemm_scheduled.launches == before
    assert cache.stats()["load_failures"] == 1 and plan.report.schedule_builds == 1
    got = plan.execute(vals[0], vals[1])
    assert np.array_equal(got.data, cold.execute(vals[0], vals[1]).data)


# -- flash attention (K5) -------------------------------------------------------

# (rtol, atol); see the module docstring for bfloat16's.
ATTN_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (1e-2, 1e-3)}


def _attn_inputs(device, shape, dtype, sq=None, seed=3):
    bh, s, d = shape
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((bh, sq or s, d), generator=g, device=device).to(dtype)
    k = torch.randn(shape, generator=g, device=device).to(dtype)
    v = torch.randn(shape, generator=g, device=device).to(dtype)
    return q, k, v


def _attn_check(q, k, v, **kw):
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    rtol, atol = ATTN_TOL[q.dtype]
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)
    return got


@pytest.mark.parametrize("bh,s,d", [(2, 256, 64), (4, 512, 128), (1, 1024, 128),
                                    (2, 2048, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_vs_plain(cuda, bh, s, d, causal, dtype):
    _attn_check(*_attn_inputs(cuda, (bh, s, d), dtype), causal=causal)


@pytest.mark.parametrize("window", [64, 128, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_window(cuda, window, dtype):
    _attn_check(*_attn_inputs(cuda, (2, 512, 64), dtype), causal=True, window=window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_q_offset(cuda, dtype):
    q, k, v = _attn_inputs(cuda, (1, 512, 64), dtype)
    part = _attn_check(q[:, 256:].contiguous(), k, v, causal=True, q_offset=256)
    full = ref.flash_attention_ref(q, k, v, causal=True)
    rtol, atol = ATTN_TOL[dtype]
    torch.testing.assert_close(part.float(), full[:, 256:], rtol=rtol, atol=atol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_fully_masked_rows(cuda, causal, dtype):
    """Rows 119.. of q see no key (window 64, q_offset 200, 256 keys); the
    first kv tiles of many rows are fully masked."""
    q, k, v = _attn_inputs(cuda, (2, 256, 64), dtype, sq=128)
    got = _attn_check(q, k, v, causal=causal, window=64, q_offset=200)
    assert torch.all(got[:, 119:] == 0)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("sq,skv,d", [(100, 200, 8), (65, 130, 72), (64, 64, 256),
                                      (1, 3, 16), (200, 333, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_ragged_and_head_dims(cuda, sq, skv, d, dtype):
    q, k, v = _attn_inputs(cuda, (3, skv, d), dtype, sq=sq)
    _attn_check(q, k, v, causal=True, q_offset=skv - sq)
    _attn_check(q, k, v, causal=False, window=17)


def test_flash_kernel_launch_counts_by_dtype(cuda):
    """``bf16_launches`` counts the tensor-core kernel's launches only."""
    before, before_tc = flash_attention.launches, flash_attention.bf16_launches
    for dtype in (torch.float32, torch.bfloat16):
        flash_attention(*_attn_inputs(cuda, (1, 128, 64), dtype))
    assert flash_attention.launches == before + 2
    assert flash_attention.bf16_launches == before_tc + 1


def test_flash_kernel_refusals(cuda):
    q, k, v = _attn_inputs(cuda, (1, 64, 264), torch.float32)
    with pytest.raises(ValueError, match="multiple of 8 up to 256"):
        flash_attention(q, k, v)
    q, k, v = _attn_inputs(cuda, (1, 64, 12), torch.float32)
    with pytest.raises(ValueError, match="multiple of 8 up to 256"):
        flash_attention(q, k, v)
    q, k, v = _attn_inputs(cuda, (1, 64, 64), torch.float32)
    with pytest.raises(ValueError, match="one device"):
        flash_attention(q, k.cpu(), v)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    # Not a refusal any more: inputs that require grad take the recompute
    # VJP (K5 forward, plain backward).
    assert ops.attention(q.requires_grad_(), k, v).grad_fn is not None


def test_lm_forward_on_card_through_the_kernel(cuda):
    """The reduced granite at S = 512 on the card: every layer's prefill
    attention launches K5, and the logits equal the port's CPU forward
    (the plain version) on the same weights."""
    cfg = get_reduced("granite-3-2b").with_(dtype="float32")
    params = tr.init_lm(0, cfg, device="cpu")
    on_card = copy.deepcopy(params).to(cuda)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 512)))
    want, _ = tr.forward(params, cfg, tokens=toks)
    before = flash_attention.launches
    got, _ = tr.forward(on_card, cfg, tokens=toks.to(cuda))
    torch.cuda.synchronize()
    assert flash_attention.launches == before + cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s", [1, 8, 200, 1000, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_at_any_length_runs_the_kernel(cuda, monkeypatch, s, dtype):
    """``attn_forward`` on the card takes K5 at every sequence length (not
    only multiples of 512): one launch per call, no torch attention path,
    and the kernel's output holds against the plain version on the same
    q, k, v within ``ATTN_TOL``."""
    _prefill_runs_the_kernel(cuda, monkeypatch, 2, s, dtype)


@pytest.mark.parametrize("s", [8, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_at_batch_1_runs_the_kernel(cuda, monkeypatch, s, dtype):
    """The same at batch 1, where flattening q's heads is a strided view
    that ``attn_forward`` must make contiguous for the kernel."""
    _prefill_runs_the_kernel(cuda, monkeypatch, 1, s, dtype)


def _prefill_runs_the_kernel(cuda, monkeypatch, b, s, dtype):
    from repro_torch.models import attention

    cfg = get_reduced("granite-3-2b").with_(dtype="float32")
    params = tr.init_lm(0, cfg, device="cpu")
    layer = copy.deepcopy(params["layers"][0]["mixer"]).to(cuda)

    def no_torch_path(*_a, **_k):
        raise AssertionError("a torch attention path ran on the card")

    monkeypatch.setattr(attention, "_gqa_scores_apply", no_torch_path)
    real = ops.attention
    seen = []

    def spy(q, k, v, *rest):
        out = real(q, k, v, *rest)
        want = ref.flash_attention_ref(q, k, v, causal=rest[0], window=rest[1],
                                       q_offset=rest[2])
        rtol, atol = ATTN_TOL[dtype]
        torch.testing.assert_close(out.float(), want, rtol=rtol, atol=atol)
        seen.append(tuple(q.shape))
        return out

    monkeypatch.setattr(ops, "attention", spy)
    x = torch.from_numpy(np.random.default_rng(s).standard_normal((b, s, cfg.d_model))
                         .astype(np.float32)).to(cuda, dtype)
    before = flash_attention.launches
    with torch.no_grad():
        y = attention.attn_forward(layer, x, cfg.with_(kernel_backend="cuda"))
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1 and len(seen) == 1
    assert seen[0][1] == s and tuple(y.shape) == (b, s, cfg.d_model)
    assert bool(torch.isfinite(y).all())


# -- block-sparse SpMM (K3) -----------------------------------------------------

BSR_SHAPES = [(64, 256, 256, 128, 128), (200, 384, 512, 128, 128), (128, 256, 384, 128, 128),
              (100, 96, 192, 32, 64), (256, 512, 384, 64, 192)]


def _bsr_case(m, k, n, bk, bn, seed, integer=False, kill_panel=None):
    rng = np.random.default_rng(seed)
    wd = random_block_sparse(k, n, (bk, bn), 0.5, seed=seed)
    if kill_panel is not None:
        wd[:, kill_panel * bn:(kill_panel + 1) * bn] = 0.0
    if integer:
        wd = np.where(wd != 0, rng.integers(-3, 4, wd.shape), 0).astype(np.float32)
        x = rng.integers(-3, 4, (m, k)).astype(np.float32)
    else:
        x = rng.standard_normal((m, k)).astype(np.float32)
    return x, wd, to_bcsv(wd, (bk, bn), group=1)


@pytest.mark.parametrize("m,k,n,bk,bn", BSR_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bsr_kernel_vs_plain(cuda, m, k, n, bk, bn, dtype):
    x, _, w = _bsr_case(m, k, n, bk, bn, seed=7)
    xt = torch.from_numpy(x).to(cuda, dtype)
    before = (bsr_spmm.launches, bsr_spmm.bf16_launches)
    got = ops.sparse_dense_matmul(xt, w, tm=32)
    assert (bsr_spmm.launches, bsr_spmm.bf16_launches) == (
        before[0] + 1, before[1] + (dtype == torch.bfloat16))
    want = ops.sparse_dense_matmul(xt.cpu(), w, tm=32)  # the plain version
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("m,k,n,bk,bn", BSR_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bsr_kernel_small_integers_bitwise(cuda, m, k, n, bk, bn, dtype):
    """Small integers are exact in bf16 and every sum is exact in float32:
    both kernels bitwise equal to x @ W."""
    x, wd, w = _bsr_case(m, k, n, bk, bn, seed=3, integer=True)
    got = ops.sparse_dense_matmul(torch.from_numpy(x).to(cuda, dtype), w, tm=32)
    assert torch.equal(got.cpu(), torch.from_numpy(x @ wd))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bsr_kernel_empty_column_panel(cuda, dtype):
    x, wd, w = _bsr_case(64, 256, 512, 128, 128, seed=8, kill_panel=1)
    xt = torch.from_numpy(x).to(cuda, dtype)
    # x @ W on the operands as the kernel reads them (rounded to dtype).
    want = xt.float().cpu() @ torch.from_numpy(wd).to(dtype).float()
    got = ops.sparse_dense_matmul(xt, w).cpu()
    assert torch.all(got[:, 128:256] == 0)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    # A panel with no block at all (bsr_spmm called directly): zeros.
    order = np.lexsort((w.brow, w.bcol))
    blocks = torch.from_numpy(w.blocks[order]).to(cuda, dtype)
    got = bsr_spmm(xt, blocks, w.brow[order], w.bcol[order], np.zeros(w.nnzb, np.int32),
                   n=512, tm=64).cpu()
    assert torch.all(got[:, 128:256] == 0)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("m,bn", [(100, 20), (200, 36), (64, 132)])
@pytest.mark.parametrize("integer", [False, True])
def test_bsr_kernel_bf16_padded_rows(cuda, m, bn, integer):
    """bf16 with bn % 8 != 0: TMA needs 16-byte rows, so the wrapper pads
    each block's rows to a multiple of 8 values; the padding columns are
    never written out."""
    x, wd, w = _bsr_case(m, 96, 3 * bn, 32, bn, seed=12, integer=integer)
    xt = torch.from_numpy(x).to(cuda, torch.bfloat16)
    before = bsr_spmm.bf16_launches
    got = ops.sparse_dense_matmul(xt, w, tm=1)
    assert bsr_spmm.bf16_launches == before + 1
    want = ops.sparse_dense_matmul(xt.cpu(), w, tm=1)
    torch.cuda.synchronize()
    if integer:
        assert torch.equal(got.cpu(), torch.from_numpy(x @ wd))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bsr_kernel_staged_index(cuda, dtype):
    """The kernel alone on indices staged once equals ``bsr_spmm``, call
    after call; nothing is kept between calls. M = 600 takes two 256-row
    tiles and a ragged third."""
    x, _, w = _bsr_case(600, 384, 512, 128, 128, seed=9)
    order = np.lexsort((w.brow, w.bcol))
    xt = torch.from_numpy(x).to(cuda, dtype)
    blocks = torch.from_numpy(w.blocks[order]).to(cuda, dtype)
    brow, bcol = w.brow[order], w.bcol[order]
    want = bsr_spmm(xt, blocks, brow, bcol, np.zeros(w.nnzb, np.int32), n=512, tm=8)
    plain = ref.bsr_spmm_ref(xt.cpu(), blocks.cpu(), brow, bcol, 512)
    torch.testing.assert_close(want.cpu(), plain, rtol=1e-3, atol=1e-3)
    index = stage_bsr_index(brow, bcol, k_blocks=3, n_panels=4, device=cuda)
    before = bsr_spmm.launches
    for _ in range(2):
        assert torch.equal(bsr_spmm_staged(xt, blocks, index, n=512), want)
    assert bsr_spmm.launches == before + 2
    with pytest.raises(ValueError, match="do not match the staged index"):
        bsr_spmm_staged(xt, blocks[1:].contiguous(), index, n=512)
    with pytest.raises(ValueError, match="on x's device"):
        bsr_spmm_staged(xt, blocks, stage_bsr_index(brow, bcol, k_blocks=3, n_panels=4,
                                                    device="cpu"), n=512)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bsr_kernel_refusals(cuda, dtype):
    x, _, w = _bsr_case(64, 96, 128, 24, 32, seed=1)
    blocks = torch.from_numpy(w.blocks).to(cuda, dtype)
    order = np.lexsort((w.brow, w.bcol))
    with pytest.raises(ValueError, match="multiple of 16"):
        bsr_spmm(torch.from_numpy(x).to(cuda, dtype), blocks[order], w.brow[order],
                 w.bcol[order], np.zeros(w.nnzb, np.int32), n=128, tm=64)
    x, _, w = _bsr_case(64, 96, 12, 32, 6, seed=1)
    order = np.lexsort((w.brow, w.bcol))
    with pytest.raises(ValueError, match="multiple of 4"):
        bsr_spmm(torch.from_numpy(x).to(cuda, dtype),
                 torch.from_numpy(w.blocks[order]).to(cuda, dtype), w.brow[order],
                 w.bcol[order], np.zeros(w.nnzb, np.int32), n=12, tm=64)


# -- grouped matmul (K4) ---------------------------------------------------------

GMM_SHAPES = [(256, 128, 256, 2, 128), (512, 256, 128, 4, 128), (1024, 128, 384, 8, 128),
              (96, 48, 200, 5, 8), (192, 64, 132, 3, 16), (320, 32, 64, 4, 32),
              (384, 96, 260, 3, 64)]


def _gmm_case(t, d, f, e, tm, seed, dtype, device, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        x = rng.integers(-3, 4, (t, d)).astype(np.float32)
        w = rng.integers(-3, 4, (e, d, f)).astype(np.float32)
    else:
        x = rng.standard_normal((t, d)).astype(np.float32)
        w = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
    te = rng.integers(0, e, t // tm).astype(np.int32)
    return (torch.from_numpy(x).to(device, dtype), torch.from_numpy(w).to(device, dtype),
            torch.from_numpy(te).to(device))


@pytest.mark.parametrize("t,d,f,e,tm", GMM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_kernel_vs_plain(cuda, t, d, f, e, tm, dtype):
    x, w, te = _gmm_case(t, d, f, e, tm, 2, dtype, cuda)
    before = moe_gmm.launches
    got = ops.grouped_matmul(x, w, te, tm=tm)
    assert moe_gmm.launches == before + 1
    want = ref.moe_gmm_ref(x, w, te, tm)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and tuple(got.shape) == (t, f)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("t,d,f,e,tm", GMM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_kernel_small_integers_bitwise(cuda, t, d, f, e, tm, dtype):
    """Small integers are exact in bf16 and every sum is exact in float32,
    whatever the order: bitwise, F = 132 and 260 included (the bf16 path
    pads w's rows to a multiple of 8 there)."""
    x, w, te = _gmm_case(t, d, f, e, tm, 4, dtype, cuda, integer=True)
    before = moe_gmm.bf16_launches
    got = moe_gmm(x, w, te.cpu().numpy(), tm=tm)
    assert moe_gmm.bf16_launches == before + (dtype == torch.bfloat16)
    assert torch.equal(got, ref.moe_gmm_ref(x, w, te, tm))


def test_gmm_kernel_refusals_and_bad_experts(cuda):
    x, w, te = _gmm_case(64, 32, 16, 3, 8, 1, torch.float32, cuda)
    with pytest.raises(ValueError, match="tm a multiple of 8"):
        moe_gmm(x, w, torch.zeros(16, dtype=torch.int32, device=cuda), tm=4)
    with pytest.raises(ValueError, match="D a multiple of 16"):
        moe_gmm(x[:, :24].contiguous(), w[:, :24].contiguous(), te, tm=8)
    with pytest.raises(ValueError, match=r"outside \[0, 3\)"):
        moe_gmm(x, w, np.full(8, 3, np.int32), tm=8)
    bad = te.clone()
    bad[2] = 7  # built on the card: not checked on the host; NaN rows, no stray reads
    for dtype in (torch.float32, torch.bfloat16):
        got = moe_gmm(x.to(dtype), w.to(dtype), bad, tm=8).cpu()
        assert torch.isnan(got[16:24]).all() and torch.isfinite(got[:16]).all()
        assert torch.isfinite(got[24:]).all()


@pytest.mark.parametrize("tm,din,dout", [(128, 2048, 768), (128, 768, 2048), (8, 2048, 768),
                                         (8, 768, 2048)])
def test_gmm_kernel_qwen3_tiles(cuda, tm, din, dout):
    """qwen3-moe-30b-a3b's expert widths (gate/up D 2048 -> F 768, down
    768 -> 2048) at the prefill's tile (tm 128) and decode's (tm 8), bf16,
    over 6 tiles of 4 experts; tile 3's expert is out of range (built on
    the card): its rows are NaN, every other row matches the plain
    version."""
    e, nt = 4, 6
    x, w, _ = _gmm_case(nt * tm, din, dout, e, tm, 9, torch.bfloat16, cuda)
    te = torch.tensor([0, 0, 1, e + 3, 2, 3], dtype=torch.int32, device=cuda)
    got = moe_gmm(x, w, te, tm=tm)
    good = torch.ones(nt * tm, dtype=torch.bool, device=cuda)
    good[3 * tm:4 * tm] = False
    want = ref.moe_gmm_ref(x[good], w, te[te < e], tm)
    torch.cuda.synchronize()
    assert torch.isnan(got[~good]).all()
    torch.testing.assert_close(got[good], want, rtol=1e-4, atol=1e-4)


def test_moe_forward_on_card_through_the_kernel(cuda):
    """The reduced qwen3-moe-30b-a3b at S = 512 on the card: every MoE
    layer launches K4 three times, every attention layer K5 once, and the
    logits equal the port's CPU forward (the plain versions) on the same
    weights."""
    cfg = get_reduced("qwen3-moe-30b-a3b").with_(dtype="float32")
    params = tr.init_lm(0, cfg, device="cpu")
    on_card = copy.deepcopy(params).to(cuda)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 512)))
    want, want_aux = tr.forward(params, cfg, tokens=toks)
    before_k4, before_k5 = moe_gmm.launches, flash_attention.launches
    got, aux = tr.forward(on_card, cfg, tokens=toks.to(cuda))
    torch.cuda.synchronize()
    assert moe_gmm.launches == before_k4 + 3 * cfg.n_layers
    assert flash_attention.launches == before_k5 + cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5, atol=1e-6)


# -- the other architectures' K5 and K4 shapes ---------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,d,kw", [
    (16, 512, 80, dict(causal=False)),               # hubert-xlarge: D 80, encoder
    (8, 1024, 120, dict(causal=True, window=256)),   # h2o-danube-3-4b: D 120, windowed
    (8, 768, 256, dict(causal=True)),                # paligemma-3b: D 256
    (16, 512, 128, dict(causal=True)),               # command-r, yi, llama4, jamba: D 128
])
def test_flash_kernel_new_arch_head_widths(cuda, bh, s, d, kw, dtype):
    """The head widths of the eight architectures beyond granite and
    qwen3 (D 80 and 120 zero-padded to the 128-wide kernel, D 256 its
    widest), non-causal and windowed as their configs ask."""
    _attn_check(*_attn_inputs(cuda, (bh, s, d), dtype), **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_mqa_repeated_kv(cuda, dtype):
    """paligemma's MQA: one kv head repeated for 8 query heads, as
    ``attn_forward`` flattens it (R = 8), against the plain version."""
    q, k, v = _attn_inputs(cuda, (2, 640, 256), dtype)
    q = torch.cat([q] * 4)  # 8 query heads
    k = k[:1].repeat_interleave(8, dim=0).contiguous()
    v = v[:1].repeat_interleave(8, dim=0).contiguous()
    _attn_check(q.contiguous(), k, v, causal=True)


@pytest.mark.parametrize("tm,din,dout", [(128, 5120, 8192), (128, 8192, 5120),
                                         (128, 4096, 14336), (128, 14336, 4096)])
def test_gmm_kernel_llama4_and_jamba_expert_widths(cuda, tm, din, dout):
    """llama4-scout's experts (D 5120 <-> F 8192) and jamba's (D 4096 <->
    F 14336), bf16, at the prefill's tile over 4 tiles of 2 experts."""
    x, w, _ = _gmm_case(4 * tm, din, dout, 2, tm, 10, torch.bfloat16, cuda)
    te = torch.tensor([0, 0, 1, 1], dtype=torch.int32, device=cuda)
    before = moe_gmm.bf16_launches
    got = ops.grouped_matmul(x, w, te, tm=tm)
    assert moe_gmm.bf16_launches == before + 1
    want = ref.moe_gmm_ref(x, w, te, tm)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["hubert-xlarge", "command-r-35b", "yi-9b",
                                  "h2o-danube-3-4b", "mamba2-130m", "llama4-scout-17b-a16e",
                                  "paligemma-3b", "jamba-v0.1-52b"])
def test_new_arch_forward_on_card_through_the_kernels(cuda, arch):
    """Each reduced config at S = 512 on the card: K5 once per attention
    layer, K4 three times per MoE layer (none for mamba2), and the logits
    equal the port's CPU forward (the plain versions) on the same weights
    and inputs (``SyntheticLM``'s frames, patches and tokens)."""
    from repro_torch.data.pipeline import SyntheticLM

    cfg = get_reduced(arch).with_(dtype="float32")
    params = tr.init_lm(0, cfg, device="cpu")
    on_card = copy.deepcopy(params).to(cuda)
    batch = SyntheticLM(cfg, 2, 512, seed=1).batch_at(0)
    inputs = {k: torch.from_numpy(batch[k]) for k in ("tokens", "feats") if k in batch}
    if "tokens" in inputs:
        inputs["tokens"] = inputs["tokens"].long()
    want, want_aux = tr.forward(params, cfg, **inputs)
    before_k4, before_k5 = moe_gmm.launches, flash_attention.launches
    got, aux = tr.forward(on_card, cfg, **{k: v.to(cuda) for k, v in inputs.items()})
    torch.cuda.synchronize()
    specs = [cfg.block_pattern[i % cfg.period] for i in range(cfg.n_layers)]
    assert flash_attention.launches == before_k5 + sum(b.mixer == "attn" for b in specs)
    assert moe_gmm.launches == before_k4 + 3 * sum(b.ff == "moe" for b in specs)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5, atol=1e-6)


# -- the autotuner and the gateway (K1/K2 through them) ----------------------------------

def test_best_ms_waits_for_the_device_inside_the_timed_region(cuda):
    """A thunk that only enqueues work returns at once; ``best_ms`` waits
    for the device of its result between its two timer calls, so it
    reports at least the enqueued sleep's device time."""
    from repro_torch.core.tuning import best_ms, interleaved_best_ms

    marker = torch.zeros(1, device=cuda)
    cycles = 20_000_000  # ~10 ms at the card's clock
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    slept_ms = start.elapsed_time(end)
    assert slept_ms > 1.0

    def thunk():
        torch.cuda._sleep(cycles)
        return [marker]

    assert best_ms(thunk, 3) >= 0.95 * slept_ms
    assert min(interleaved_best_ms([thunk, lambda: (marker,)], 2)[:1]) >= 0.95 * slept_ms


def test_autotune_on_card_keeps_kernel_tiles_and_is_bitwise(cuda):
    """The default grid on the card holds only tiles K1 takes (around tile
    64: {32, 64, 128} x groups {2, 4, 8}); the probes launch K2 (batches)
    and K1 (depth streams); the tuned plan equals an untuned plan at the
    winner's (tile, group) bitwise; a tile K1 refuses raises before any
    plan is built."""
    from repro_torch.spgemm import PlanCache, schedule_build_count
    from repro_torch.spgemm.autotune import autotune_plan

    a = suite_matrix("poisson3Da", scale=0.05, seed=0)
    record = {}
    k1, k2 = spgemm_scheduled.launches, spgemm_scheduled_batch.launches
    tuned = autotune_plan(a, a, tile=64, group=4, device=cuda, cache=PlanCache(),
                          probe_batch=4, repeats=2, record=record)
    torch.cuda.synchronize()
    assert spgemm_scheduled_batch.launches > k2 and spgemm_scheduled.launches > k1
    grid = [(tuple(c["tile"]), c["group"]) for c in record["candidates"]]
    assert sorted({t[0] for t, _ in grid}) == [32, 64, 128] and len(grid) == 9
    assert all(all(d % 16 == 0 and 16 <= d <= 128 for d in p["tile"]) for p in record["probes"])
    cfg = tuned.tuned_config
    assert tuned.backend == "cuda" and cfg.probes > 0 and cfg.values_per_s > 0
    ref = spgemm_plan(a, a, tile=cfg.tile, group=cfg.group, device=cuda, cache=PlanCache())
    vals = np.random.default_rng(7).standard_normal((3, 2, a.nnz)).astype(np.float32)
    for x, y in zip(tuned.execute_batch(vals[:, 0], vals[:, 1]),
                    ref.execute_batch(vals[:, 0], vals[:, 1])):
        assert np.array_equal(x.data, y.data)
    for i, got in enumerate(tuned.execute_stream((vals[i, 0], vals[i, 1]) for i in range(3))):
        assert np.array_equal(got.data, ref.execute(vals[i, 0], vals[i, 1]).data)
    builds = schedule_build_count()
    with pytest.raises(ValueError, match="multiples of 16"):
        autotune_plan(a, a, tile=8, group=4, device=cuda, cache=PlanCache())
    assert schedule_build_count() == builds


def test_gateway_on_card_bitwise_equals_execute(cuda):
    """Two tenants served on the card from three submitter threads, values
    as numpy arrays and as CUDA tensors: every result equals a direct
    ``execute`` bitwise, each dispatch runs K2 (once per chunk of its
    batch), none runs K1, and a result kept from an early step is not
    overwritten by later steps."""
    from repro_torch.spgemm import Outcome, PlanCache, SpGEMMGateway
    from repro_torch.data.pipeline import SpGEMMValueStream

    a = suite_matrix("poisson3Da", scale=0.05, seed=0)
    b = suite_matrix("poisson3Da", scale=0.05, seed=1)
    plans = {"aa": spgemm_plan(a, a, tile=64, group=4, device=cuda, cache=PlanCache()),
             "ab": spgemm_plan(a, b, tile=32, group=2, device=cuda, cache=PlanCache())}
    streams = {k: SpGEMMValueStream(p.a_pattern, p.b_pattern, seed=i)
               for i, (k, p) in enumerate(plans.items())}
    results = {}
    k1, k2 = spgemm_scheduled.launches, spgemm_scheduled_batch.launches
    with SpGEMMGateway(cache=PlanCache(), max_batch=4, depth=2, batch_window=0.002) as gw:
        for k, p in plans.items():
            gw.register_plan(k, p)

        def tenant(tid, key):
            tickets = []
            for s in range(12):
                av, bv = streams[key].values_at(100 * tid + s)
                if s % 2:
                    av = torch.from_numpy(av).to(cuda)
                tickets.append((100 * tid + s, gw.submit(key, av, bv)))
            for step, t in tickets:
                results[(key, step)] = t.wait(120)

        import threading

        threads = [threading.Thread(target=tenant, args=(i, k))
                   for i, k in enumerate(["aa", "ab", "aa"])]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        stats = gw.stats()["patterns"]
    torch.cuda.synchronize()
    served_k1 = spgemm_scheduled.launches - k1
    served_k2 = spgemm_scheduled_batch.launches - k2
    assert len(results) == 36 and all(r.outcome is Outcome.OK for r in results.values())
    first = results[("aa", 0)].value.data.copy()
    for (key, step), r in results.items():
        assert np.array_equal(r.value.data, plans[key].execute(*streams[key].values_at(step)).data)
    assert np.array_equal(results[("aa", 0)].value.data, first)
    assert served_k1 == 0
    chunks = {k: min(4, p._executor.batch_chunk()) for k, p in plans.items()}
    dispatches = sum(stats[k]["dispatches"] for k in plans)
    batched = sum(stats[k]["batched_requests"] for k in plans)
    assert batched == 36 and dispatches < 36
    assert dispatches <= served_k2 <= batched
    if all(c == 1 for c in chunks.values()):
        assert served_k2 == batched


# -- training on the card ---------------------------------------------------------

def test_grouped_and_sparse_matmul_refuse_grad_on_card(cuda):
    """K3 and K4 write a fresh tensor outside autograd: CUDA operands that
    require grad are refused, where the gradient would be dropped without
    a word; without grad (or under no_grad) they launch as before."""
    x, w, te = _gmm_case(256, 128, 256, 2, 128, 2, torch.float32, cuda)
    for xg, wg in ((x.clone().requires_grad_(), w), (x, w.clone().requires_grad_())):
        with pytest.raises(NotImplementedError, match="MoE training on the card"):
            ops.grouped_matmul(xg, wg, te, tm=128)
    before = moe_gmm.launches
    with torch.no_grad():
        ops.grouped_matmul(x.clone().requires_grad_(), w, te, tm=128)
    assert moe_gmm.launches == before + 1
    xs, _, bw = _bsr_case(64, 256, 256, 128, 128, seed=7)
    xt = torch.from_numpy(xs).to(cuda).requires_grad_()
    with pytest.raises(NotImplementedError, match="MoE training on the card"):
        ops.sparse_dense_matmul(xt, bw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,sq", [(None, 512), (128, 512), (None, 200)])
def test_attention_backward_on_card_equals_plain_autograd(cuda, dtype, window, sq):
    """``ops.attention`` on CUDA inputs that require grad: K5 forward (one
    launch), the plain recompute backward. Its output holds against the
    plain version within ``ATTN_TOL``; dq, dk, dv equal autograd through
    the plain version (the same computation) within the same tolerance."""
    q, k, v = _attn_inputs(cuda, (2, 512, 64), dtype, sq=sq)
    off = 512 - sq
    g = torch.randn(q.shape, device=cuda).to(dtype)
    t = [x.clone().requires_grad_() for x in (q, k, v)]
    before = flash_attention.launches
    out = ops.attention(*t, True, window, off)
    assert flash_attention.launches == before + 1
    got = torch.autograd.grad(out, t, g)
    t2 = [x.clone().requires_grad_() for x in (q, k, v)]
    plain = ref.flash_attention_ref(*t2, causal=True, window=window, q_offset=off).to(dtype)
    want = torch.autograd.grad(plain, t2, g)
    rtol, atol = ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(), plain.float(), rtol=rtol, atol=atol)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=atol)


def test_train_step_on_card_through_k5(cuda):
    """Two ``make_train_step`` steps of the reduced granite (float32, remat
    "full") on 2 x 512 tokens on the card: K5 launches twice per layer per
    step (the forward and the remat recompute), and the first step's
    metrics equal the CPU step's on the same weights and batch within
    1e-4 (the forward's tolerance on the card)."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import AdamW
    from repro_torch.runtime.steps import make_train_step

    cfg = get_reduced("granite-3-2b").with_(dtype="float32")
    assert cfg.remat == "full"
    params = tr.init_lm(0, cfg, device="cpu", trainable=True)
    on_card = copy.deepcopy(params).to(cuda)
    opt = AdamW(lr=1e-3)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(cfg, 2, 512).batch_at(0).items()}
    _, _, want = make_train_step(cfg, opt)(params, opt.init(params), batch)
    step = make_train_step(cfg, opt)
    state = opt.init(on_card)
    for i in range(2):
        before = flash_attention.launches
        on_card, state, met = step(on_card, state, {k: v.to(cuda) for k, v in batch.items()})
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 2 * cfg.n_layers
        assert all(bool(torch.isfinite(m)) for m in met.values())
        if i == 0:
            for key in ("loss", "grad_norm", "total_loss"):
                torch.testing.assert_close(met[key].cpu(), want[key], rtol=1e-4, atol=1e-4)


def _expert_case(e, cap, d, f, dtype, device, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e * cap, d)).astype(np.float32)
    w = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
    g = rng.standard_normal((e * cap, f)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device, dtype) for a in (x, w, g))


def _expert_plain_grads(x, w, g):
    """y, dx, dw by autograd through the reference's einsum over [E, C, D]
    in float32 (dx and dw come back in the inputs' dtype)."""
    e, d, f = w.shape
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = torch.einsum("ecd,edf->ecf", xs.float().view(e, -1, d), ws.float()).reshape(-1, f)
    return (y.detach(), *torch.autograd.grad(y, (xs, ws), g.float()))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("cap", [32, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_matmul_backward_on_card_equals_plain_autograd(cuda, dtype, cap, remat):
    """``models.moe._ExpertMatmul`` on the card: one K4 launch forward (and
    one more in the recompute under ``checkpoint(use_reentrant=False)``),
    two backward (dx, dw; capacity 24 pads dw's contraction to 32); y, dx
    and dw against autograd through the plain einsum within K4's 1e-4 of
    each result's scale in float32, 2e-2 in bfloat16 (the outputs are
    rounded to it)."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.models import moe

    e, d, f = 4, 128, 256
    tm = moe._tile_rows(cap)
    te = torch.arange(e, dtype=torch.int32, device=cuda).repeat_interleave(cap // tm)
    x, w, g = _expert_case(e, cap, d, f, dtype, cuda)
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()

    def run(a, b):
        return moe._ExpertMatmul.apply(a, b, te, tm, "auto")

    before = moe_gmm.launches
    y = checkpoint(run, xs, ws, use_reentrant=False) if remat else run(xs, ws)
    assert moe_gmm.launches == before + 1
    dx, dw = torch.autograd.grad(y, (xs, ws), g)
    torch.cuda.synchronize()
    assert moe_gmm.launches == before + (4 if remat else 3)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, want in zip((y, dx, dw), _expert_plain_grads(x, w, g)):
        assert got.dtype == dtype and got.shape == want.shape
        scale = float(want.abs().max())
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol * scale)


def test_moe_train_step_on_card_through_k4(cuda):
    """Two ``make_train_step`` steps of the reduced qwen3-moe-30b-a3b
    (float32, remat "full") on 2 x 512 tokens on the card: per step, K4
    launches 12 times per MoE layer (3 forward, 3 in the recompute, 6 in
    the backward) and K5 twice per attention layer; the first step's
    metrics equal the CPU step's on the same weights and batch within
    1e-4 (the forward's tolerance on the card)."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import AdamW
    from repro_torch.runtime.steps import make_train_step

    cfg = get_reduced("qwen3-moe-30b-a3b").with_(dtype="float32")
    assert cfg.remat == "full"
    params = tr.init_lm(0, cfg, device="cpu", trainable=True)
    on_card = copy.deepcopy(params).to(cuda)
    opt = AdamW(lr=1e-3)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(cfg, 2, 512).batch_at(0).items()}
    _, _, want = make_train_step(cfg, opt)(params, opt.init(params), batch)
    step = make_train_step(cfg, opt)
    state = opt.init(on_card)
    for i in range(2):
        k4, k5 = moe_gmm.launches, flash_attention.launches
        on_card, state, met = step(on_card, state, {k: v.to(cuda) for k, v in batch.items()})
        torch.cuda.synchronize()
        assert moe_gmm.launches == k4 + 12 * cfg.n_layers
        assert flash_attention.launches == k5 + 2 * cfg.n_layers
        assert all(bool(torch.isfinite(m)) for m in met.values())
        if i == 0:
            for key in ("loss", "moe_aux", "grad_norm", "total_loss"):
                torch.testing.assert_close(met[key].cpu(), want[key], rtol=1e-4, atol=1e-4)
