"""Port parity: plan/execute SpGEMM of ``repro_torch`` (on the CPU, the
plain PyTorch path) against ``repro.spgemm.spgemm_plan(backend="jnp")``.

indptr/indices must equal the reference's bitwise, data within 1e-5, and
bitwise with small-integer values; ``execute_batch`` must equal looped
``execute`` bitwise. Also: the plan is held against the Gustavson oracle,
built from the reference's persisted artifacts, reached through the
``ops.spgemm`` shim, refuses a missing card, and the package imports
neither JAX nor the JAX package.
"""
import ast
import os
import pathlib

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro.sparse.convert import to_bcsr as r_to_bcsr, to_bcsv as r_to_bcsv  # noqa: E402
from repro.sparse.formats import COO as R_COO  # noqa: E402
from repro.sparse.random import random_coo as r_random_coo  # noqa: E402
from repro.spgemm import PlanCache  # noqa: E402
from repro.spgemm import spgemm_plan as r_spgemm_plan  # noqa: E402
from repro_torch.core.gustavson import spgemm_gustavson  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.gustavson_spgemm import (  # noqa: E402
    spgemm_scheduled,
    spgemm_scheduled_batch,
)
from repro_torch.sparse.convert import to_bcsr, to_bcsv, to_csr  # noqa: E402
from repro_torch.sparse.formats import COO  # noqa: E402
from repro_torch.sparse.random import random_block_sparse, suite_matrix  # noqa: E402
from repro_torch.spgemm import (  # noqa: E402
    CHUNK_BYTES_ENV,
    SpGEMMPlan,
    resolve_backend,
    resolve_chunk_bytes,
    spgemm_plan,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _int_coo(m, n, density, seed):
    """Small-integer float32 values: exact under any summation order."""
    coo = r_random_coo(m, n, density, "uniform", seed=seed)
    rng = np.random.default_rng(seed + 999)
    vals = rng.integers(-4, 5, coo.nnz).astype(np.float32)
    return np.where(vals == 0, np.float32(1.0), vals), coo


def _pair(coo_r, vals=None):
    """The same COO for both packages (numpy arrays handed to each)."""
    v = coo_r.val if vals is None else vals
    return (COO(coo_r.row, coo_r.col, v, coo_r.shape),
            R_COO(coo_r.row, coo_r.col, v, coo_r.shape))


def _transpose(csr):
    coo = csr.to_coo()
    return COO(coo.col, coo.row, coo.val, (csr.shape[1], csr.shape[0]))


def _assert_csr_match(got, want, tol):
    assert got.shape == want.shape
    assert np.array_equal(got.indptr, want.indptr)
    assert np.array_equal(got.indices, want.indices)
    if tol == 0:
        assert np.array_equal(got.data, np.asarray(want.data))
    else:
        np.testing.assert_allclose(got.data, np.asarray(want.data), rtol=tol, atol=tol)


@pytest.mark.parametrize("name,scale,tile,group", [
    ("poisson3Da", 0.02, 32, 4),
    ("2cubes_sphere", 0.005, 64, 4),
    ("scircuit", 0.005, 32, 2),
    ("cage12", 0.004, 16, 4),
])
def test_plan_matches_reference_on_paper_matrices(name, scale, tile, group):
    a = suite_matrix(name, scale=scale, seed=0)
    b = _transpose(a)
    plan = spgemm_plan(a, b, tile=tile, group=group, device="cpu")
    ac = a.to_coo()
    want = r_spgemm_plan(R_COO(ac.row, ac.col, ac.val, ac.shape),
                         R_COO(b.row, b.col, b.val, b.shape),
                         tile=tile, group=group, backend="jnp",
                         cache=PlanCache())
    _assert_csr_match(plan.execute(), want.execute(), 1e-5)
    oracle = spgemm_gustavson(a, to_csr(b))
    np.testing.assert_allclose(plan.execute().todense(), oracle.todense(),
                               rtol=1e-4, atol=1e-4)
    # The report carries the reference's fields and values.
    got_r, want_r = plan.report.as_dict(), want.report.as_dict()
    assert got_r.keys() == want_r.keys()
    for f in ("pattern_key", "tile", "group", "shape", "nnz_a", "nnz_b",
              "nnzb_a", "nnzb_b", "nnzb_c", "num_triples", "n_panels",
              "b_fetches", "block_omar"):
        assert got_r[f] == want_r[f], f


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_small_integers_bitwise(seed, backend):
    """Bitwise with the reference and the oracle, on the plain backend and
    through the kernel wrappers' CPU path."""
    va, ca = _int_coo(90, 70, 0.08, seed)
    vb, cb = _int_coo(70, 110, 0.1, seed + 10)
    (ta, ra), (tb, rb) = _pair(ca, va), _pair(cb, vb)
    plan = spgemm_plan(ta, tb, tile=16, group=2, backend=backend, device="cpu")
    got = plan.execute()
    want = r_spgemm_plan(ra, rb, tile=16, group=2, backend="jnp",
                         cache=PlanCache()).execute()
    _assert_csr_match(got, want, 0)
    assert np.array_equal(got.todense(), spgemm_gustavson(to_csr(ta), to_csr(tb)).todense())


def test_execute_batch_equals_looped_execute_bitwise():
    a = suite_matrix("poisson3Da", scale=0.02, seed=3)
    plan = spgemm_plan(a, a, tile=32, group=4, device="cpu")
    rng = np.random.default_rng(4)
    av = rng.standard_normal((5, a.nnz)).astype(np.float32)
    bv = rng.standard_normal((5, a.nnz)).astype(np.float32)
    batch = plan.execute_batch(av, bv)
    assert len(batch) == 5
    for i in range(5):
        single = plan.execute(av[i], bv[i])
        assert np.array_equal(batch[i].data, single.data)
        assert batch[i].indptr is single.indptr
    # Torch tensors (bfloat16 too) are accepted and cast to float32.
    tb = plan.execute_batch(torch.from_numpy(av[:2]).bfloat16(), torch.from_numpy(bv[:2]))
    assert np.array_equal(
        tb[1].data,
        plan.execute(torch.from_numpy(av[1]).bfloat16().float().numpy(), bv[1]).data)
    assert plan.report.executes == 5 + 5 + 2 + 1


def test_execute_batch_matches_reference_batch():
    va, ca = _int_coo(64, 48, 0.1, 5)
    vb, cb = _int_coo(48, 80, 0.1, 6)
    (ta, ra), (tb, rb) = _pair(ca, va), _pair(cb, vb)
    plan = spgemm_plan(ta, tb, tile=16, group=2, device="cpu")
    want_plan = r_spgemm_plan(ra, rb, tile=16, group=2, backend="jnp", cache=PlanCache())
    rng = np.random.default_rng(7)
    av = rng.integers(-3, 4, (3, ca.nnz)).astype(np.float32)
    bv = rng.integers(-3, 4, (3, cb.nnz)).astype(np.float32)
    for got, want in zip(plan.execute_batch(av, bv), want_plan.execute_batch(av, bv)):
        _assert_csr_match(got, want, 0)


def test_block_plan_batch_and_staged_values():
    ad = random_block_sparse(128, 192, (32, 32), 0.3, seed=1)
    bd = random_block_sparse(192, 96, (32, 32), 0.35, seed=2)
    a, b = to_bcsv(ad, (32, 32), 2), to_bcsr(bd, (32, 32))
    plan = spgemm_plan(a, b, device="cpu")
    assert plan.report.tile == (32, 32, 32) and plan.report.group == 2
    want = r_spgemm_plan(r_to_bcsv(ad, (32, 32), 2), r_to_bcsr(bd, (32, 32)),
                         backend="jnp", cache=PlanCache()).execute()
    _assert_csr_match(plan.execute(), want, 1e-5)
    np.testing.assert_allclose(plan.execute().todense(),
                               ad.astype(np.float64) @ bd, rtol=1e-4, atol=1e-4)
    rng = np.random.default_rng(0)
    a2 = rng.standard_normal((2,) + a.blocks.shape).astype(np.float32)
    b2 = rng.standard_normal((2,) + b.blocks.shape).astype(np.float32)
    batch = plan.execute_batch(a2, b2)
    for i in range(2):
        assert np.array_equal(batch[i].data, plan.execute(a2[i], b2[i]).data)
    # No-arg execute reuses the values of the last execute.
    assert np.array_equal(plan.execute().data, batch[1].data)
    assert plan.report.nnz_a == np.count_nonzero(a2[1])


def test_element_plan_staged_values_follow_rebinds():
    a = suite_matrix("scircuit", scale=0.005, seed=2)
    plan = spgemm_plan(a, a, tile=32, group=4, device="cpu")
    first = plan.execute()
    v = np.full(a.nnz, 2.0, np.float32)
    fresh = plan.execute(v, v)
    assert np.array_equal(plan.execute().data, fresh.data)
    assert not np.array_equal(first.data, fresh.data)
    with pytest.raises(ValueError, match="canonical pattern order"):
        plan.execute(v[:-1], v)


@pytest.mark.parametrize("kind", ["element", "block"])
def test_from_artifacts_of_reference_plan(kind):
    if kind == "element":
        va, ca = _int_coo(80, 60, 0.1, 11)
        vb, cb = _int_coo(60, 72, 0.12, 12)
        (ta, ra), (tb, rb) = _pair(ca, va), _pair(cb, vb)
        ref_plan = r_spgemm_plan(ra, rb, tile=16, group=2, backend="jnp",
                                 cache=PlanCache())
        arrays, meta = ref_plan.persist_artifacts()
        plan = SpGEMMPlan.from_artifacts(arrays, meta, device="cpu",
                                         a_vals=va, b_vals=vb, a_pattern=ta,
                                         b_pattern=tb)
        direct = spgemm_plan(ta, tb, tile=16, group=2, device="cpu")
    else:
        ad = random_block_sparse(96, 64, (32, 32), 0.4, seed=5)
        bd = random_block_sparse(64, 96, (32, 32), 0.4, seed=6)
        ref_plan = r_spgemm_plan(r_to_bcsv(ad, (32, 32), 2), r_to_bcsr(bd, (32, 32)),
                                 backend="jnp", cache=PlanCache())
        arrays, meta = ref_plan.persist_artifacts()
        a, b = to_bcsv(ad, (32, 32), 2), to_bcsr(bd, (32, 32))
        plan = SpGEMMPlan.from_artifacts(arrays, meta, device="cpu",
                                         a_blocks=a.blocks, b_blocks=b.blocks)
        direct = spgemm_plan(a, b, device="cpu")
    assert plan.report.schedule_builds == 0 and plan.report.loads == 1
    got = plan.execute()
    _assert_csr_match(got, ref_plan.execute(), 1e-5 if kind == "block" else 0)
    assert np.array_equal(got.data, direct.execute().data)


def test_from_artifacts_rejects_unported_and_inconsistent():
    va, ca = _int_coo(40, 40, 0.1, 3)
    _, ra = _pair(ca, va)
    ref_plan = r_spgemm_plan(ra, ra, tile=16, group=2, backend="jnp", cache=PlanCache())
    arrays, meta = ref_plan.persist_artifacts()
    with pytest.raises(ValueError, match="only block output"):
        SpGEMMPlan.from_artifacts(arrays, dict(meta, output="compact"),
                                  device="cpu", a_vals=va, b_vals=va)
    with pytest.raises(ValueError, match="persisted scatter"):
        SpGEMMPlan.from_artifacts(arrays, meta, device="cpu", a_vals=va[:-1], b_vals=va)
    with pytest.raises(ValueError, match="a_vals/b_vals"):
        SpGEMMPlan.from_artifacts(arrays, meta, device="cpu")


@pytest.mark.parametrize("with_schedule", [False, True])
def test_ops_spgemm_shim(with_schedule):
    from repro_torch.core.schedule import build_spgemm_schedule

    ad = random_block_sparse(192, 256, (64, 64), 0.3, seed=3)
    bd = random_block_sparse(256, 192, (64, 64), 0.35, seed=4)
    a, b = to_bcsv(ad, (64, 64), 2), to_bcsr(bd, (64, 64))
    sch = build_spgemm_schedule(a, b) if with_schedule else None
    c = ops.spgemm(a, b, device="cpu", schedule=sch)
    np.testing.assert_allclose(c.todense(), ad.astype(np.float64) @ bd.astype(np.float64),
                               rtol=1e-4, atol=1e-4)


def test_empty_inputs():
    a = COO(np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np.float32), (32, 16))
    va, cb = _int_coo(16, 24, 0.2, 3)
    b, _ = _pair(cb, va)
    plan = spgemm_plan(a, b, tile=8, group=2, device="cpu")
    c = plan.execute()
    assert c.nnz == 0 and c.shape == (32, 24)
    assert [x.nnz for x in plan.execute_batch(np.zeros((2, 0), np.float32),
                                              np.zeros((2, cb.nnz), np.float32))] == [0, 0]
    assert plan.device_indptr().tolist() == [0] * 33


def test_device_indptr_matches_host_indptr():
    a = suite_matrix("cage12", scale=0.004, seed=1)
    plan = spgemm_plan(a, a, tile=16, group=4, device="cpu")
    got = plan.device_indptr()
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), plan.execute().indptr.astype(np.int32))


def test_no_fallback_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the test checks the refusal")
    a = suite_matrix("poisson3Da", scale=0.005, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spgemm_plan(a, a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.spgemm(to_bcsv(a, (16, 16), 2), to_bcsr(a, (16, 16)))


def test_backend_resolution():
    assert resolve_backend("auto", "cpu") == "torch"
    assert resolve_backend("auto", "cuda") == "cuda"
    assert resolve_backend("cuda", "cpu") == "cuda"
    with pytest.raises(ValueError, match="plain CPU version"):
        resolve_backend("torch", "cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("jnp", "cpu")


def test_wrapped_kernel_path_launches_nothing_on_cpu():
    a = suite_matrix("poisson3Da", scale=0.01, seed=0)
    before = (spgemm_scheduled.launches, spgemm_scheduled_batch.launches)
    plan = spgemm_plan(a, a, tile=32, group=4, backend="cuda", device="cpu")
    plain = spgemm_plan(a, a, tile=32, group=4, device="cpu")
    assert np.array_equal(plan.execute().data, plain.execute().data)
    plan.execute_batch(np.ones((2, a.nnz), np.float32), np.ones((2, a.nnz), np.float32))
    assert (spgemm_scheduled.launches, spgemm_scheduled_batch.launches) == before


def test_chunk_policy(monkeypatch):
    monkeypatch.delenv(CHUNK_BYTES_ENV, raising=False)
    assert resolve_chunk_bytes(None, "cpu") == ((3 << 20) // 4, 8 << 20)
    assert resolve_chunk_bytes(1 << 20, "cpu") == (1 << 20, int((8 << 20) * 4 / 3))
    monkeypatch.setenv(CHUNK_BYTES_ENV, str(3 << 20))
    assert resolve_chunk_bytes(1 << 20, "cpu")[0] == 3 << 20
    a = suite_matrix("poisson3Da", scale=0.01, seed=0)
    assert spgemm_plan(a, a, tile=32, device="cpu").report.config_source == "env-override"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), (
                f"{os.path.relpath(path, ROOT)} imports {mod}")
