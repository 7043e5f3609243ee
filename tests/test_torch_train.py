"""Port parity of the training path: ``lm_loss`` and every parameter's
gradient, one ``make_train_step`` step (also with two microbatches), the
remat policies, ``_token_nll``'s compute-dtype backward and the attention
VJP, against the JAX package's ``jax.value_and_grad`` of the same
functions.

The models are the reduced granite-3-2b (attention + MLP) and
qwen3-moe-30b-a3b (attention + MoE, with the router's load-balance loss)
of tests/test_models.py, in float32, the reference's weights carried over
by ``params_from_jax``, a ``SyntheticLM`` batch of 2 x 32 tokens.

Tolerance. Loss: rtol 1e-5. Gradients: each leaf within 5e-4 of the
largest magnitude of the reference's gradient of that leaf. Both sides
compute in float32 and round in different places; the reference's
initialiser draws layer weights with std 1/sqrt(n_periods) (0.71 here),
so attention logits are large and the softmax is sharply peaked, and
one-ulp differences (XLA fuses RoPE, torch rounds each product) reach the
gradients amplified: the largest difference measured on these configs is
8.7e-5 of a leaf's scale. One AdamW step moves each element by up to lr
times a ratio m / sqrt(v) near +-1, whatever the gradient's size; an
element whose gradient is about zero can flip that ratio under the
difference above, so new params are held within 2 lr (absolute) and,
everywhere but at such elements (|g| below 1e-3 of its leaf's scale),
within 1e-5.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.configs.registry import get_reduced as r_get_reduced  # noqa: E402
from repro.data.pipeline import SyntheticLM  # noqa: E402
from repro.kernels import ops as r_ops  # noqa: E402
from repro.models import transformer as r_tr  # noqa: E402
from repro.optim import AdamW as RAdamW  # noqa: E402
from repro.runtime.steps import make_train_step as r_make_train_step  # noqa: E402
from repro_torch.configs.registry import get_reduced  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.tree import flatten_with_paths, tree_leaves  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.runtime.steps import make_train_step  # noqa: E402

ARCHS = ["granite-3-2b", "qwen3-moe-30b-a3b"]
LOSS_RTOL = 1e-5
GRAD_TOL = 5e-4
LR = 1e-3


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def _ported(tree, cfg, trainable=False):
    """The reference's (stacked) tree in the port's layout, on the CPU."""
    return params_from_jax(jax.tree.map(np.asarray, tree), cfg, device="cpu",
                           trainable=trainable)


def _leaves_within_scale(got, want, tol=GRAD_TOL):
    got_flat, want_flat = flatten_with_paths(got), flatten_with_paths(want)
    assert [p for p, _ in got_flat] == [p for p, _ in want_flat]
    for (path, g), (_, w) in zip(got_flat, want_flat):
        w = _np(w)
        scale = float(np.abs(w).max(initial=0.0))
        np.testing.assert_allclose(_np(g), w, rtol=0, atol=tol * max(scale, 1e-30),
                                   err_msg=path)


class _Case:
    def __init__(self, arch):
        self.r_cfg = r_get_reduced(arch).with_(dtype="float32")
        self.p_cfg = get_reduced(arch).with_(dtype="float32")
        self.r_params = r_tr.init_lm(jax.random.PRNGKey(0), self.r_cfg)
        self.batch = SyntheticLM(self.r_cfg, 2, 32, seed=0).batch_at(0)

    def port_params(self):
        return _ported(self.r_params, self.p_cfg, trainable=True)

    def port_batch(self):
        return {k: torch.from_numpy(v) for k, v in self.batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    c = _Case(request.param)

    def loss_fn(p):
        return r_tr.lm_loss(p, c.r_cfg, tokens=jnp.asarray(c.batch["tokens"]),
                            labels=jnp.asarray(c.batch["labels"]))

    (c.r_total, c.r_metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        c.r_params)
    c.r_grads = _ported(grads, c.p_cfg)
    return c


def _port_loss_and_grads(c, cfg=None):
    params = c.port_params()
    total, metrics = tr.lm_loss(params, cfg or c.p_cfg, **c.port_batch())
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(total, leaves)
    return params, total, metrics, grads


def test_lm_loss_and_every_gradient_match_reference(case):
    params, total, metrics, grads = _port_loss_and_grads(case)
    np.testing.assert_allclose(float(total.detach()), float(case.r_total), rtol=LOSS_RTOL)
    for k in ("loss", "moe_aux"):
        np.testing.assert_allclose(float(metrics[k]), float(case.r_metrics[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    if case.p_cfg.has_moe:
        assert float(metrics["moe_aux"]) > 0
    it = iter(grads)
    _leaves_within_scale({p: next(it) for p, _ in flatten_with_paths(params)},
                         dict(flatten_with_paths(case.r_grads)))


def test_lm_loss_with_mask_matches_reference():
    """A mask selects the positions the loss averages over."""
    c = _Case("granite-3-2b")
    mask = (np.random.default_rng(3).random((2, 32)) < 0.5).astype(np.float32)
    want, _ = r_tr.lm_loss(c.r_params, c.r_cfg, tokens=jnp.asarray(c.batch["tokens"]),
                           labels=jnp.asarray(c.batch["labels"]), mask=jnp.asarray(mask))
    got, _ = tr.lm_loss(c.port_params(), c.p_cfg, **c.port_batch(),
                        mask=torch.from_numpy(mask))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch,microbatches", [("granite-3-2b", 1), ("granite-3-2b", 2),
                                               ("qwen3-moe-30b-a3b", 1)])
def test_train_step_matches_reference(arch, microbatches):
    """One ``make_train_step`` step with AdamW(lr 1e-3, weight decay 0.01)
    and clipping at 1.0: the metrics and the new params against the
    reference's step on the same params and batch."""
    c = _Case(arch)
    r_opt = RAdamW(lr=LR, weight_decay=0.01)
    r_step = jax.jit(r_make_train_step(c.r_cfg, r_opt, microbatches=microbatches))
    r_new, _, r_met = r_step(c.r_params, r_opt.init(c.r_params),
                             {k: jnp.asarray(v) for k, v in c.batch.items()})
    opt = AdamW(lr=LR, weight_decay=0.01)
    params = c.port_params()
    old = [p.detach().clone() for p in tree_leaves(params)]
    step = make_train_step(c.p_cfg, opt, microbatches=microbatches)
    new, state, met = step(params, opt.init(params), c.port_batch())
    assert sorted(met) == sorted(r_met) == ["grad_norm", "loss", "moe_aux", "total_loss"]
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(r_met[k]), rtol=GRAD_TOL, atol=1e-7,
                                   err_msg=k)
    assert int(state["step"]) == 1
    # The gradient (clipping scales a leaf uniformly) marks the elements
    # whose update sign is ill-conditioned.
    _, _, _, grads = _port_loss_and_grads(c)
    want_new = dict(flatten_with_paths(_ported(r_new, c.p_cfg)))
    moved = False
    for (path, got), g, before in zip(flatten_with_paths(new), grads, old):
        w = _np(want_new[path])
        np.testing.assert_allclose(_np(got), w, rtol=0, atol=2 * LR, err_msg=path)
        g = np.abs(_np(g))
        firm = g > 1e-3 * g.max(initial=0.0)
        np.testing.assert_allclose(_np(got)[firm], w[firm], rtol=0, atol=1e-5, err_msg=path)
        moved |= not torch.equal(got.detach(), before)
    assert moved


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_gradients_of_none_bitwise(case, policy):
    """Recomputing each layer in the backward (``"full"``) or all but its
    plain matrix products (``"dots"``) changes no bit of any gradient."""
    _, t0, _, g0 = _port_loss_and_grads(case, case.p_cfg.with_(remat="none"))
    _, t1, _, g1 = _port_loss_and_grads(case, case.p_cfg.with_(remat=policy))
    assert torch.equal(t0, t1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_remat_recomputes_each_layer_once_in_the_backward(monkeypatch):
    """``"full"`` runs every layer's forward twice per step (forward, then
    the recompute), ``"none"`` once; serving (no grad) never wraps."""
    from repro_torch.models import transformer

    c = _Case("granite-3-2b")
    calls = []
    real = transformer.block_forward

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(transformer, "block_forward", counting)
    for policy, want in (("none", 1), ("full", 2)):
        calls.clear()
        params = c.port_params()
        total, _ = tr.lm_loss(params, c.p_cfg.with_(remat=policy), **c.port_batch())
        torch.autograd.grad(total, tree_leaves(params))
        assert len(calls) == want * c.p_cfg.n_layers, policy
    calls.clear()
    with torch.no_grad():
        tr.forward(c.port_params(), c.p_cfg, tokens=c.port_batch()["tokens"])
    assert len(calls) == c.p_cfg.n_layers


def test_remat_unknown_policy_raises():
    c = _Case("granite-3-2b")
    with pytest.raises(ValueError, match="remat"):
        tr.lm_loss(c.port_params(), c.p_cfg.with_(remat="most"), **c.port_batch())


# -- _token_nll ---------------------------------------------------------------

def _logits_labels(seed, shape=(2, 16, 96)):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal(shape)).astype(np.float32)
    labels = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    g = rng.standard_normal(shape[:-1]).astype(np.float32)
    return logits, labels, g


def test_token_nll_backward_equals_autograd_through_cross_entropy():
    """float32: value and backward against autograd through plain
    cross-entropy, within 1e-6 (float32, one rounding order apart)."""
    logits, labels, g = _logits_labels(0)
    a = torch.from_numpy(logits).requires_grad_()
    b = torch.from_numpy(logits).requires_grad_()
    nll = tr._token_nll(a, torch.from_numpy(labels))
    ce = F.cross_entropy(b.reshape(-1, 96), torch.from_numpy(labels).long().reshape(-1),
                         reduction="none").reshape(2, 16)
    torch.testing.assert_close(nll, ce, rtol=1e-6, atol=1e-6)
    (da,) = torch.autograd.grad(nll, a, torch.from_numpy(g))
    (db,) = torch.autograd.grad(ce, b, torch.from_numpy(g))
    torch.testing.assert_close(da, db, rtol=1e-6, atol=1e-6)


def test_token_nll_bf16_backward_matches_reference():
    """bfloat16 logits: the gradient stays bfloat16, as the reference's
    ``_token_nll_bwd``, and equals it within one bf16 rounding (2**-8 of
    each element: both sides round exp(logits - lse) once to bf16, from
    float32 exponentials that may differ in the last ulp)."""
    logits, labels, g = _logits_labels(1)
    a = torch.from_numpy(logits).to(torch.bfloat16).requires_grad_()
    (da,) = torch.autograd.grad(tr._token_nll(a, torch.from_numpy(labels)), a,
                                torch.from_numpy(g))
    _, vjp = jax.vjp(lambda x: r_tr._token_nll(x, jnp.asarray(labels)),
                     jnp.asarray(logits).astype(jnp.bfloat16))
    (want,) = vjp(jnp.asarray(g))
    assert da.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(da), _np(want), rtol=2 ** -8, atol=1e-6)


# -- the attention VJP -----------------------------------------------------------

@pytest.mark.parametrize("causal,window,sq,q_offset", [(True, None, 64, 0), (False, None, 64, 0),
                                                       (True, 24, 64, 0), (True, None, 40, 24)])
def test_attention_function_grads_equal_plain_autograd(causal, window, sq, q_offset):
    """``ops.attention`` on CPU tensors that require grad goes through the
    recompute VJP (its forward is the plain version here): its dq, dk, dv
    equal autograd through the plain version bitwise, and match the
    reference's VJP within 2e-4 (the JAX package's attention tolerance)."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((3, sq, 16)).astype(np.float32)
    k, v = (rng.standard_normal((3, 64, 16)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((3, sq, 16)).astype(np.float32)
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ops.attention(*t, causal, window, q_offset)
    assert type(out.grad_fn).__name__ == "_AttentionBackward"
    got = torch.autograd.grad(out, t, torch.from_numpy(g))
    t2 = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    plain = ref.flash_attention_ref(*t2, causal=causal, window=window, q_offset=q_offset)
    want = torch.autograd.grad(plain, t2, torch.from_numpy(g))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    _, vjp = jax.vjp(lambda a, b, c: r_ops.attention(a, b, c, causal, window, q_offset, "jnp"),
                     *(jnp.asarray(x) for x in (q, k, v)))
    for a, b in zip(got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-4)


def test_attention_without_grad_takes_no_autograd_function():
    q = torch.zeros((1, 8, 8))
    assert ops.attention(q, q, q).grad_fn is None
    with torch.no_grad():
        assert ops.attention(q.requires_grad_(), q, q).grad_fn is None


def test_train_step_refuses_params_without_grad():
    c = _Case("granite-3-2b")
    params = _ported(c.r_params, c.p_cfg)  # serving params
    opt = AdamW()
    with pytest.raises(ValueError, match="trainable=True"):
        make_train_step(c.p_cfg, opt)(params, opt.init(params), c.port_batch())
