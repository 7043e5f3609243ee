"""Port parity of the ``ops`` facade's two kernel entry points:
``sparse_dense_matmul`` (K3, the block-sparse-weight SpMM) and
``grouped_matmul`` (K4, the MoE grouped matmul), their host work
(``plan_bsr``, the zero-block padding of empty column panels, M padding),
the plain versions they run on CPU tensors, and the wrappers' input checks.

The JAX side runs its Pallas kernels in interpret mode (``backend=
"pallas_interpret"``, ``moe_gmm(interpret=True)``) or its jnp oracles, on
inputs made with numpy from a seed. Host arrays (orderings, padding,
flags) must agree bitwise. Float tolerances: 1e-4 for the grouped matmul
(the JAX package's own); 1e-3 for the SpMM in float32 (its own) and in
bfloat16 too, where the JAX package allows 0.15 against an oracle on
unrounded float32 inputs: here both sides multiply the same bfloat16
values in float32 and differ only in summation order. With small-integer
values every float32 sum is exact and the results agree bitwise. The
CUDA kernels are held against the same plain versions in
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as r_ops  # noqa: E402
from repro.kernels import ref as r_ref  # noqa: E402
from repro.kernels.bsr_spmm import plan_bsr as r_plan_bsr  # noqa: E402
from repro.kernels.moe_gmm import moe_gmm as r_moe_gmm  # noqa: E402
from repro.models import mlp as r_mlp  # noqa: E402
from repro.sparse.convert import to_bcsv as r_to_bcsv  # noqa: E402
from repro.sparse.random import random_block_sparse  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.bsr_spmm import bsr_spmm, plan_bsr  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.sparse.convert import to_bcsv  # noqa: E402

# The JAX package's K3 and K4 test shapes (tests/test_kernels.py).
BSR_SHAPES = [(64, 256, 256, 128, 128), (200, 384, 512, 128, 128), (128, 256, 384, 128, 128)]
GMM_SHAPES = [(256, 128, 256, 2, 128), (512, 256, 128, 4, 128), (1024, 128, 384, 8, 128)]
DTYPES = {"float32": (np.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _weight(k, n, bk, bn, seed, kill_panel=None, integer=False):
    wd = random_block_sparse(k, n, (bk, bn), 0.5, seed=seed)
    if kill_panel is not None:
        wd[:, kill_panel * bn:(kill_panel + 1) * bn] = 0.0
    if integer:
        rng = np.random.default_rng(seed + 100)
        wd = np.where(wd != 0, rng.integers(-3, 4, wd.shape), 0).astype(np.float32)
    return wd, r_to_bcsv(wd, (bk, bn), group=1), to_bcsv(wd, (bk, bn), group=1)


def _capture(monkeypatch, module, name):
    """Replace ``module.name`` by a wrapper that records its arguments."""
    seen = []
    real = getattr(module, name)

    def spy(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(module, name, spy)
    return seen


# -- K3: host ordering and padding -------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_bsr_bitwise(seed):
    rng = np.random.default_rng(seed)
    nnzb = 40
    brow = rng.integers(0, 12, nnzb).astype(np.int32)
    bcol = rng.integers(0, 7, nnzb).astype(np.int32)
    for got, want in zip(plan_bsr(brow, bcol), r_plan_bsr(brow, bcol)):
        assert got.dtype == np.asarray(want).dtype
        assert np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("kill_panel", [None, 1, 3])
def test_padded_operands_bitwise(monkeypatch, kill_panel):
    """The kernel's operands after the column-panel-major reorder, the
    zero-block padding of empty panels and the M padding are the
    reference's, array for array."""
    _, r_w, w = _weight(256, 512, 128, 128, seed=8, kill_panel=kill_panel)
    x = np.random.default_rng(1).standard_normal((72, 256)).astype(np.float32)
    r_seen = _capture(monkeypatch, r_ops, "bsr_spmm")
    seen = _capture(monkeypatch, ops, "bsr_spmm")
    r_ops.sparse_dense_matmul(jnp.asarray(x), r_w, backend="pallas_interpret", tm=32)
    ops.sparse_dense_matmul(torch.from_numpy(x), w, tm=32)
    (r_args, r_kw), (args, kw) = r_seen[0], seen[0]
    assert tuple(args[0].shape) == tuple(r_args[0].shape) == (96, 256)
    assert np.array_equal(_np(args[0]), np.asarray(r_args[0]))
    assert np.array_equal(_np(args[1]), np.asarray(r_args[1]))
    for got, want in zip(args[2:5], r_args[2:5]):
        assert np.array_equal(np.asarray(got), np.asarray(want))
    assert kw["n"] == r_kw["n"] == 512 and kw["tm"] == r_kw["tm"] == 32
    n_panels_with_blocks = len(set(np.asarray(r_w.bcol).tolist()))
    assert args[1].shape[0] == r_w.nnzb + (4 - n_panels_with_blocks)


# -- K3: values ----------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,bk,bn", BSR_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sparse_dense_matmul_vs_pallas(m, k, n, bk, bn, dtype):
    np_dt, t_dt = DTYPES[dtype]
    x = np.random.default_rng(0).standard_normal((m, k)).astype(np.float32)
    wd, r_w, w = _weight(k, n, bk, bn, seed=7)
    r_w.blocks = r_w.blocks.astype(np_dt)
    want = r_ops.sparse_dense_matmul(jnp.asarray(x.astype(np_dt)), r_w,
                                     backend="pallas_interpret")
    got = ops.sparse_dense_matmul(torch.from_numpy(x).to(t_dt), w)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=1e-3, atol=1e-3)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), x @ wd, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("backend", ["auto", "torch", "cuda"])
def test_sparse_dense_matmul_small_integers_bitwise(backend):
    """Ragged M (200, padded to 256 and sliced back) with exact sums: the
    port equals the reference's Pallas kernel bit for bit; every backend
    takes the plain version for CPU tensors."""
    x = np.random.default_rng(3).integers(-3, 4, (200, 384)).astype(np.float32)
    _, r_w, w = _weight(384, 512, 128, 128, seed=5, integer=True)
    want = r_ops.sparse_dense_matmul(jnp.asarray(x), r_w, backend="pallas_interpret")
    got = ops.sparse_dense_matmul(torch.from_numpy(x), w, backend=backend)
    assert np.array_equal(_np(got), np.asarray(want))


def test_empty_column_panels_are_zero():
    _, r_w, w = _weight(256, 512, 128, 128, seed=8, kill_panel=1)
    x = np.random.default_rng(1).standard_normal((64, 256)).astype(np.float32)
    got = _np(ops.sparse_dense_matmul(torch.from_numpy(x), w))
    assert np.abs(got[:, 128:256]).max() == 0.0
    want = r_ops.sparse_dense_matmul(jnp.asarray(x), r_w, backend="pallas_interpret")
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=1e-3)


def test_bsr_spmm_checks():
    _, _, w = _weight(256, 512, 128, 128, seed=2)
    _, brow, bcol, flags = plan_bsr(w.brow, w.bcol)
    blocks = torch.from_numpy(w.blocks[np.lexsort((w.brow, w.bcol))])
    x = torch.zeros((128, 256))
    with pytest.raises(ValueError, match="multiple of tm"):
        bsr_spmm(x[:100], blocks, brow, bcol, flags, n=512)
    with pytest.raises(ValueError, match="non-decreasing"):
        bsr_spmm(x, blocks, brow, bcol[::-1].copy(), flags, n=512)
    with pytest.raises(ValueError, match="block grid"):
        bsr_spmm(x, blocks, brow + 2, bcol, flags, n=512)
    with pytest.raises(ValueError, match="nnzb"):
        bsr_spmm(x, blocks, brow[1:], bcol[1:], flags[1:], n=512)
    with pytest.raises(TypeError, match="float32 or both bfloat16"):
        bsr_spmm(x, blocks.double(), brow, bcol, flags, n=512)
    with pytest.raises(ValueError, match="backend"):
        ops.sparse_dense_matmul(x, w, backend="pallas")
    with pytest.raises(ValueError, match="x must be"):
        ops.sparse_dense_matmul(x[:, :128], w)


def test_sparse_block_mask_follows_reference_rule(monkeypatch):
    """The reference's rule applied to the same uniform draws: the
    reference draws them with jax.random (replaced here by the port's
    draws), the port with a torch.Generator."""
    gen = torch.Generator().manual_seed(3)
    got = mlp.sparse_block_mask(gen, 8192, 2048, 128, 0.25)
    u = torch.rand((64, 16), generator=torch.Generator().manual_seed(3))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(u.numpy()))
    want = r_mlp.sparse_block_mask(jax.random.PRNGKey(0), 8192, 2048, 128, 0.25)
    assert np.array_equal(_np(got), np.asarray(want))
    assert tuple(got.shape) == (64, 16) and bool((got[0] == 1).all())
    assert 256 <= int(got.sum()) <= 272


# -- K4 --------------------------------------------------------------------------

@pytest.mark.parametrize("t,d,f,e,tm", GMM_SHAPES)
def test_grouped_matmul_vs_pallas(t, d, f, e, tm):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = rng.standard_normal((e, d, f)).astype(np.float32)
    te = np.sort(rng.integers(0, e, t // tm)).astype(np.int32)
    want = r_moe_gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(te), tm=tm, bd=128, bf=128,
                     interpret=True)
    got = ops.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w), te, tm=tm)
    assert got.dtype == torch.float32 and tuple(got.shape) == (t, f)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tm", [8, 16])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_grouped_matmul_small_tiles_vs_oracle(tm, as_tensor):
    rng = np.random.default_rng(4)
    t, d, f, e = 96, 64, 48, 5
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = rng.standard_normal((e, d, f)).astype(np.float32)
    te = rng.integers(0, e, t // tm).astype(np.int32)  # unsorted is allowed
    want = r_ref.moe_gmm_ref(jnp.asarray(x), jnp.asarray(w), te, tm)
    got = moe_gmm(torch.from_numpy(x), torch.from_numpy(w),
                  torch.from_numpy(te) if as_tensor else te, tm=tm)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_grouped_matmul_small_integers_bitwise():
    rng = np.random.default_rng(6)
    x = rng.integers(-3, 4, (512, 256)).astype(np.float32)
    w = rng.integers(-3, 4, (4, 256, 128)).astype(np.float32)
    te = np.array([0, 0, 2, 3], np.int32)
    want = r_moe_gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(te), tm=128, bd=128, bf=128,
                     interpret=True)
    got = ops.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w), te, backend="cuda")
    assert np.array_equal(_np(got), np.asarray(want))


def test_moe_gmm_ref_chunks_like_one_gather(monkeypatch):
    """The plain version multiplies tiles a chunk at a time; its result
    does not depend on the chunk size."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((80, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 32, 16)).astype(np.float32))
    te = torch.from_numpy(rng.integers(0, 3, 10))
    whole = ref.moe_gmm_ref(x, w, te, 8)
    monkeypatch.setattr(ref, "_GMM_GATHER_FLOATS", 3 * 32 * 16)
    assert torch.equal(ref.moe_gmm_ref(x, w, te, 8), whole)


def test_moe_gmm_checks():
    x, w = torch.zeros((64, 32)), torch.zeros((3, 32, 16))
    te = np.zeros(8, np.int32)
    with pytest.raises(ValueError, match="multiple of tm"):
        moe_gmm(x[:60], w, te[:7], tm=8)
    with pytest.raises(ValueError, match="one expert per tile"):
        moe_gmm(x, w, te[:7], tm=8)
    with pytest.raises(ValueError, match=r"outside \[0, 3\)"):
        moe_gmm(x, w, np.full(8, 3, np.int32), tm=8)
    with pytest.raises(ValueError, match="w \\[E, D, F\\]"):
        moe_gmm(x, torch.zeros((3, 16, 16)), te, tm=8)
    with pytest.raises(TypeError, match="float32 or both bfloat16"):
        moe_gmm(x, w.bfloat16(), te, tm=8)
    with pytest.raises(TypeError, match="integers"):
        moe_gmm(x, w, np.zeros(8, np.float32), tm=8)
    with pytest.raises(ValueError, match="backend"):
        ops.grouped_matmul(x, w, te, tm=8, backend="jnp")
