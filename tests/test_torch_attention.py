"""Port parity: the plain version of the flash-attention kernel (K5) and
``ops.attention`` against the JAX package's Pallas kernel (interpret mode)
and its jnp oracle, at the JAX package's K5 test shapes
(tests/test_kernels.py), plus the wrapper's CPU path and input checks.

Float32 is held at the JAX package's own 2e-4. Both packages compute
bfloat16 inputs in float32 and round only the output to bfloat16, so they
differ by at most a rounding of the output (2**-7 of it, one bf16 ulp):
bfloat16 is held at rtol 1e-2, atol 1e-3, tighter than the JAX package's
5e-2, which is as large as a typical |output| at these shapes.
Inputs are made with numpy from a seed and handed to both packages. The
CUDA kernel itself is held against the same plain version in
tests/test_torch_cuda.py; here a plain-torch emulation of the bf16
kernel's rounding points (P as two bf16 halves, float32 sums, bf16
output) is held at the bf16 tolerance against both packages.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as r_ops, ref as r_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as r_flash  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402

# (rtol, atol); see the module docstring for bfloat16's.
TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (1e-2, 1e-3)}


def _qkv(seed, shape, sq=None):
    rng = np.random.default_rng(seed)
    bh, s, d = shape
    q = rng.standard_normal((bh, sq or s, d)).astype(np.float32)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    return q, k, v


def _jax_both(q, k, v, dtype=jnp.float32, **kw):
    """The Pallas kernel in interpret mode (tiles of 128, as the JAX tests
    run it) and the jnp oracle, as float32 numpy."""
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    kern = r_flash(jq, jk, jv, bq=min(128, q.shape[1]), bk=min(128, k.shape[1]),
                   interpret=True, **kw)
    oracle = r_ref.flash_attention_ref(jq, jk, jv, **kw)
    return np.asarray(kern, np.float32), np.asarray(oracle, np.float32)


def _port_all(q, k, v, dtype=torch.float32, **kw):
    """The port's plain version, the kernel wrapper on CPU tensors and
    ``ops.attention`` with both CPU backends, as float32 numpy."""
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    outs = {
        "ref": ref.flash_attention_ref(tq, tk, tv, **kw),
        "wrapper": flash_attention(tq, tk, tv, **kw),
        "ops_torch": ops.attention(tq, tk, tv, kw.get("causal", True), kw.get("window"),
                                   kw.get("q_offset", 0), "torch"),
        "ops_auto": ops.attention(tq, tk, tv, kw.get("causal", True), kw.get("window"),
                                  kw.get("q_offset", 0), "auto"),
    }
    for name in ("wrapper", "ops_torch", "ops_auto"):
        assert outs[name].dtype == dtype, name
    return {name: o.float().numpy() for name, o in outs.items()}


def _assert_all_close(port, jax_outs, tol):
    for name, got in port.items():
        for want in jax_outs:
            np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1], err_msg=name)


@pytest.mark.parametrize("bh,s,d", [(2, 256, 64), (4, 512, 128), (1, 1024, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_vs_jax(bh, s, d, causal):
    q, k, v = _qkv(3, (bh, s, d))
    _assert_all_close(_port_all(q, k, v, causal=causal),
                      _jax_both(q, k, v, causal=causal), TOL[torch.float32])


@pytest.mark.parametrize("window", [64, 128, 1024])
def test_sliding_window(window):
    q, k, v = _qkv(4, (2, 512, 64))
    _assert_all_close(_port_all(q, k, v, causal=True, window=window),
                      _jax_both(q, k, v, causal=True, window=window), TOL[torch.float32])


def test_q_offset_chunked_prefill():
    """The second half of the queries against the full kv, with
    q_offset 256, equals those rows of one-shot attention."""
    q, k, v = _qkv(5, (1, 512, 64))
    port = _port_all(q[:, 256:], k, v, causal=True, q_offset=256)
    _assert_all_close(port, _jax_both(q[:, 256:], k, v, causal=True, q_offset=256),
                      TOL[torch.float32])
    full = ref.flash_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)), causal=True)
    np.testing.assert_allclose(port["ref"], full[:, 256:].numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_fully_masked_rows_are_zero(causal):
    """A window and a q_offset past the end of kv leave the last rows with
    no visible key: they give 0 in both packages, the others agree."""
    q, k, v = _qkv(8, (2, 256, 64), sq=128)
    kw = dict(causal=causal, window=64, q_offset=200)
    port = _port_all(q, k, v, **kw)
    # Row i sees keys in (i + 136, i + 200] of 0..255; rows i >= 119 see none.
    for got in port.values():
        assert np.all(got[:, 119:] == 0)
        assert np.all(np.abs(got[:, :119]).sum(-1) > 0)
    _assert_all_close(port, _jax_both(q, k, v, **kw), TOL[torch.float32])


def test_bf16():
    q, k, v = _qkv(6, (2, 256, 64))
    _assert_all_close(_port_all(q, k, v, torch.bfloat16, causal=True),
                      _jax_both(q, k, v, jnp.bfloat16, causal=True), TOL[torch.bfloat16])


def _k5_bf16_emulation(q, k, v, causal=True, window=None, q_offset=0):
    """The bf16 CUDA kernel's arithmetic in plain torch: float32 logits of
    the bf16 inputs (exact products), tiles of 64 keys, an online softmax
    in the exp2 domain with the running max from -1e30, P multiplied by V
    as two bf16 halves (hi = bf16(p), lo = bf16(p - hi)) with float32
    sums, l summing the float32 p, l = 0 -> 1, output rounded to bf16."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    scale_log2 = np.float32(1.0 / np.sqrt(d) * np.log2(np.e))
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((bh, sq, 1), -1e30)
    l = torch.zeros((bh, sq, 1))
    acc = torch.zeros((bh, sq, d))
    qi = torch.arange(sq)[:, None] + q_offset
    for k0 in range(0, skv, 64):
        kj = torch.arange(k0, min(k0 + 64, skv))[None, :]
        vis = torch.ones((sq, kj.shape[1]), dtype=torch.bool)
        if causal:
            vis &= kj <= qi
        if window is not None:
            vis &= kj > qi - window
        s = torch.einsum("bqd,bkd->bqk", qf, kf[:, k0:k0 + 64]) * scale_log2
        s = s.masked_fill(~vis[None], float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float()
        vt = vf[:, k0:k0 + 64]
        acc = acc * alpha + (hi @ vt + lo @ vt)
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
    return (acc / torch.where(l == 0, torch.ones_like(l), l)).bfloat16()


def _emulation_check(q, k, v, with_jax=True, **kw):
    """The emulation against the port's float32 plain version and, where
    the Pallas kernel takes the shape, against it in interpret mode (bf16
    inputs), at the bf16 tolerance."""
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = _k5_bf16_emulation(tq, tk, tv, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    rtol, atol = TOL[torch.bfloat16]
    want = ref.flash_attention_ref(tq, tk, tv, **kw)
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)
    if with_jax:
        kern, oracle = _jax_both(*(np.asarray(x.float()) for x in (tq, tk, tv)),
                                 jnp.bfloat16, **kw)
        for other in (kern, oracle):
            np.testing.assert_allclose(got.float().numpy(), other, rtol=rtol, atol=atol)
    return got


@pytest.mark.parametrize("bh,s,d", [(2, 256, 64), (4, 512, 128), (1, 1024, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_kernel_emulation_vs_jax(bh, s, d, causal):
    _emulation_check(*_qkv(3, (bh, s, d)), causal=causal)


@pytest.mark.parametrize("window", [64, 128, 1024])
def test_bf16_kernel_emulation_window(window):
    _emulation_check(*_qkv(4, (2, 512, 64)), causal=True, window=window)


def test_bf16_kernel_emulation_q_offset():
    q, k, v = _qkv(5, (1, 512, 64))
    _emulation_check(q[:, 256:], k, v, causal=True, q_offset=256)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_kernel_emulation_fully_masked_rows(causal):
    q, k, v = _qkv(8, (2, 256, 64), sq=128)
    got = _emulation_check(q, k, v, causal=causal, window=64, q_offset=200)
    assert torch.all(got[:, 119:] == 0)


@pytest.mark.parametrize("sq,skv,d", [(100, 200, 8), (65, 130, 72), (64, 64, 256),
                                      (200, 333, 256)])
def test_bf16_kernel_emulation_ragged_and_head_dims(sq, skv, d):
    """The card tests' ragged shapes and head widths (D 8 and 72 run
    zero-padded to the kernel's 64 and 128), against the plain version."""
    q, k, v = _qkv(10, (3, skv, d), sq=sq)
    _emulation_check(q, k, v, with_jax=False, causal=True, q_offset=skv - sq)
    _emulation_check(q, k, v, with_jax=False, causal=False, window=17)


def test_bf16_kernel_emulation_lm_width():
    """The LM prefill's rows (S 2048, D 64, causal) on 8 of its 128
    heads: the longest rows, where rounding P to bf16 alone would move
    short rows' cancelling weights past atol, stay inside it with hi + lo."""
    _emulation_check(*_qkv(11, (8, 2048, 64)), with_jax=False, causal=True)


def test_cpu_wrapper_launches_nothing():
    q, k, v = (torch.from_numpy(x) for x in _qkv(9, (1, 64, 32)))
    before = flash_attention.launches
    flash_attention(q, k, v)
    ops.attention(q, k, v, backend="cuda")
    assert flash_attention.launches == before


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(2, 64, 32)
    with pytest.raises(ValueError, match="mismatched"):
        flash_attention(q, torch.zeros(2, 64, 16), torch.zeros(2, 64, 16))
    with pytest.raises(ValueError, match="mismatched"):
        flash_attention(q, torch.zeros(2, 64, 32), torch.zeros(2, 32, 32))
    with pytest.raises(ValueError, match=r"\[BH, S, D\]"):
        flash_attention(q[0], q[0], q[0])
    with pytest.raises(ValueError, match="unknown backend"):
        ops.attention(q, q, q, backend="pallas")


def test_ops_attention_cpu_backward_through_plain_version():
    """On the CPU the plain version is differentiable by autograd; its
    gradients match the reference's recompute VJP."""
    q, k, v = _qkv(7, (2, 128, 32))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    ops.attention(tq, tk, tv, True, None, 0, "torch").sum().backward()
    grads = jax.grad(lambda a, b, c: r_ops.attention(a, b, c, True, None, 0, "jnp").sum(),
                     argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
