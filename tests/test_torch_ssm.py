"""Port parity of the Mamba-2 (SSD) mixer: ``repro_torch.models.ssm``
against ``repro.models.ssm`` on the same numpy-seeded inputs and weights,
at the reduced widths of mamba2-130m and jamba-v0.1-52b.

The weights are drawn with numpy (projections with std 1/sqrt(fan-in),
convolutions 0.2, ``a_log`` in [-1, 1], ``dt_bias`` and ``d_skip`` normal)
rather than the reference's initialiser, whose ``a_log`` and ``dt_bias``
are zeros and ``d_skip`` ones: every leaf then enters with a value of its
own.

Tolerance, relative to each output's scale (``atol`` is the tolerance
times the largest magnitude of the reference's output, and at least the
tolerance): float32 1e-5 (both sides form exact products in float32 and
differ in the order of their sums); bfloat16 2e-2 (the two frameworks
round their bf16 elementwise ops in different places).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.registry import get_reduced as r_get_reduced  # noqa: E402
from repro.models import ssm as r_ssm  # noqa: E402
from repro_torch.configs.registry import get_reduced  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

ARCHS = ["mamba2-130m", "jamba-v0.1-52b"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * scale)


def _weights(cfg, seed=0):
    """numpy leaves of ``ssm_t(cfg)``: the same dict for both packages."""
    rng = np.random.default_rng(seed)
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    cw = cfg.ssm_conv_width

    def w(shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)

    return {
        "z_proj": {"w": w((d, di))}, "x_proj": {"w": w((d, di))},
        "b_proj": {"w": w((d, n))}, "c_proj": {"w": w((d, n))},
        "dt_proj": {"w": w((d, h))},
        "conv_x": (0.2 * rng.standard_normal((cw, di))).astype(np.float32),
        "conv_b": (0.2 * rng.standard_normal((cw, n))).astype(np.float32),
        "conv_c": (0.2 * rng.standard_normal((cw, n))).astype(np.float32),
        "a_log": rng.uniform(-1, 1, h).astype(np.float32),
        "d_skip": rng.standard_normal(h).astype(np.float32),
        "dt_bias": rng.standard_normal(h).astype(np.float32),
        "norm": {"scale": (1 + 0.1 * rng.standard_normal(di)).astype(np.float32)},
        "out_proj": {"w": w((di, d))},
    }


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree), jax.tree.map(torch.from_numpy, tree))


def _x(b, s, d, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _cfgs(arch, **kw):
    return r_get_reduced(arch).with_(**kw), get_reduced(arch).with_(**kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cw", [2, 4])
def test_causal_conv(dtype, cw):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((cw, 12)).astype(np.float32)
    want = r_ssm._causal_conv(jnp.asarray(x, JNP[dtype]), jnp.asarray(w, JNP[dtype]))
    got = ssm._causal_conv(torch.from_numpy(x).to(TORCH[dtype]),
                           torch.from_numpy(w).to(TORCH[dtype]))
    assert got.dtype == TORCH[dtype]
    _close(got, want, TOL[dtype])


def test_ssm_template_matches_reference():
    """The port's leaves are the reference's, with the same shapes and
    initialisers."""
    from repro.models.nn import Param as RParam

    for arch in ARCHS:
        r_cfg, p_cfg = _cfgs(arch)
        r_t = jax.tree.map(lambda p: (p.shape, p.init), r_ssm.ssm_t(r_cfg),
                           is_leaf=lambda x: isinstance(x, RParam))
        p_t = jax.tree.map(lambda p: (tuple(p.shape), p.init), ssm.ssm_t(p_cfg),
                           is_leaf=lambda x: isinstance(x, tuple))
        assert p_t == r_t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [4, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_forward(arch, chunk, dtype):
    r_cfg, p_cfg = _cfgs(arch, ssm_chunk=chunk, dtype=dtype)
    r_p, p_p = _both(_weights(p_cfg))
    x = _x(2, 32, p_cfg.d_model)
    want = r_ssm.ssm_forward(r_p, jnp.asarray(x, JNP[dtype]), r_cfg)
    got = ssm.ssm_forward(p_p, torch.from_numpy(x).to(TORCH[dtype]), p_cfg)
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == (2, 32, p_cfg.d_model)
    _close(got, want, TOL[dtype])


def test_ssm_forward_refuses_a_partial_chunk():
    _, p_cfg = _cfgs("mamba2-130m", ssm_chunk=8)
    _, p_p = _both(_weights(p_cfg))
    with pytest.raises(AssertionError, match="chunk"):
        ssm.ssm_forward(p_p, torch.from_numpy(_x(1, 12, p_cfg.d_model)), p_cfg)


def test_ssm_forward_is_finite_under_large_decays():
    """Large decays make the masked ``seg`` entries large and positive: the
    clamp before ``exp`` keeps the output and its gradient finite."""
    _, p_cfg = _cfgs("mamba2-130m", ssm_chunk=16)
    tree = _weights(p_cfg)
    tree["a_log"] = np.full_like(tree["a_log"], 4.0)  # a = -e^4 per unit dt
    tree["dt_bias"] = np.full_like(tree["dt_bias"], 5.0)
    p_p = jax.tree.map(lambda a: torch.from_numpy(a).requires_grad_(), tree)
    x = torch.from_numpy(_x(1, 32, p_cfg.d_model)).requires_grad_()
    y = ssm.ssm_forward(p_p, x, p_cfg)
    y.square().sum().backward()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(x.grad).all())
    assert all(bool(torch.isfinite(t.grad).all()) for t in jax.tree.leaves(p_p))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_decode_one_step(arch, dtype):
    r_cfg, p_cfg = _cfgs(arch, dtype=dtype)
    r_p, p_p = _both(_weights(p_cfg))
    rng = np.random.default_rng(3)
    h, n, pd = p_cfg.ssm_heads, p_cfg.ssm_state, p_cfg.ssm_head_dim
    state = rng.standard_normal((2, h, n, pd)).astype(np.float32)
    conv = rng.standard_normal(
        (2, p_cfg.ssm_conv_width - 1, p_cfg.d_inner + 2 * n)).astype(np.float32)
    x = _x(2, 1, p_cfg.d_model, seed=4)
    want = r_ssm.ssm_decode(r_p, jnp.asarray(x, JNP[dtype]), jnp.asarray(state),
                            jnp.asarray(conv, JNP[dtype]), r_cfg)
    got = ssm.ssm_decode(p_p, torch.from_numpy(x).to(TORCH[dtype]), torch.from_numpy(state),
                         torch.from_numpy(conv).to(TORCH[dtype]), p_cfg)
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, str(w.dtype)) and tuple(g.shape) == w.shape
        _close(g, w, TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_decode_run_matches_reference_and_forward(arch):
    """Twelve decode steps from an empty cache: each step's output and
    the carried state against the reference's steps, and the outputs
    against the port's own full-sequence forward."""
    r_cfg, p_cfg = _cfgs(arch, ssm_chunk=4)
    r_p, p_p = _both(_weights(p_cfg))
    s = 12
    x = _x(2, s, p_cfg.d_model, seed=5)
    r_cache = r_ssm.init_ssm_cache(r_cfg, 2, 1, jnp.float32)
    p_cache = ssm.init_ssm_cache(p_cfg, 2, 1, torch.float32, "cpu")
    r_st, r_cv = r_cache["state"][0], r_cache["conv"][0]
    st, cv = p_cache["state"][0], p_cache["conv"][0]
    steps = []
    for t in range(s):
        want, r_st, r_cv = r_ssm.ssm_decode(r_p, jnp.asarray(x[:, t:t + 1]), r_st, r_cv, r_cfg)
        got, st, cv = ssm.ssm_decode(p_p, torch.from_numpy(x[:, t:t + 1]), st, cv, p_cfg)
        _close(got, want, TOL["float32"])
        steps.append(got)
    _close(st, r_st, TOL["float32"])
    _close(cv, r_cv, TOL["float32"])
    full = ssm.ssm_forward(p_p, torch.from_numpy(x), p_cfg)
    _close(torch.cat(steps, dim=1), full, 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_ssm_cache(arch, dtype):
    r_cfg, p_cfg = _cfgs(arch)
    want = r_ssm.init_ssm_cache(r_cfg, 3, 5, JNP[dtype])
    got = ssm.init_ssm_cache(p_cfg, 3, 5, TORCH[dtype], "cpu")
    assert sorted(got) == sorted(want) == ["conv", "state"]
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == getattr(torch, str(want[k].dtype))
        assert not bool(got[k].any())
    assert got["state"].dtype == torch.float32
