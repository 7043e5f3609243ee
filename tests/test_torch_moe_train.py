"""Port parity of MoE training: the expert matmul's backward
(``models.moe._ExpertMatmul``: dx and dw as two more grouped matmuls in
the expert-blocked layout), then ``lm_loss`` and every gradient of the
reduced llama4-scout-17b-a16e, hubert-xlarge, paligemma-3b and
h2o-danube-3-4b against ``jax.value_and_grad`` of the reference's
``lm_loss``, and ``launch_train`` of the reduced qwen3-moe-30b-a3b on the
CPU (tests/test_torch_train_archs.py holds train steps of the reduced
llama4 and jamba against the reference's). On CPU tensors the grouped
matmul runs K4's plain version, so these tests hold the backward's
formulas; the card's tests (tests/test_torch_cuda.py) hold K4 in them.

Tolerances. The expert matmuls against autograd through the plain einsum
over [E, C, D]: float32 within 1e-5 of each result's scale, bfloat16
within 2e-2 (the JAX package's kernel tolerances; in bfloat16 the two
round the products' sums at different places). The model losses and
gradients: the loss rtol 1e-5 and each gradient within 5e-4 of its
leaf's scale, as tests/test_torch_train.py states and measures them.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import registry as r_registry  # noqa: E402
from repro.data.pipeline import SyntheticLM  # noqa: E402
from repro.models import transformer as r_tr  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.train import launch_train  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.tree import flatten_with_paths, tree_leaves  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.runtime.steps import make_train_step  # noqa: E402

GMM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
LOSS_RTOL = 1e-5
GRAD_TOL = 5e-4


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def _within_scale(got, want, tol, what=""):
    want = _np(want)
    scale = float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=tol * max(scale, 1e-30),
                               err_msg=what)


# -- the expert matmul's backward ------------------------------------------------

def _expert_inputs(e, c, d, f, dtype, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)

    return (t(e * c, d), t(e, d, f, scale=d ** -0.5), t(e, d, f, scale=d ** -0.5),
            t(e, f, d, scale=f ** -0.5), t(e * c, d))


def _expert_block(mm, x, wg, wu, wd, gated):
    """The MoE layer's expert compute with ``mm`` as its matmul."""
    act = torch.nn.functional.silu
    h = act(mm(x, wg)) * mm(x, wu) if gated else act(mm(x, wu))
    return mm(h, wd)


@pytest.mark.parametrize("cap", [16, 24])  # C % 16 == 0, and == 8 (dw pads C to 32)
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_matmul_backward_equals_einsum_autograd(dtype, gated, cap):
    """The expert block through ``_ExpertMatmul`` (K4's plain version on
    the CPU) against autograd through the reference's einsums
    ``"ecd,edf->ecf"`` on the same [E, C, D] layout: the output, dx and
    every dw, in the working dtype."""
    e, d, f = 3, 32, 48
    tm = moe._tile_rows(cap)
    te = torch.arange(e, dtype=torch.int32).repeat_interleave(cap // tm)
    x, wg, wu, wd, g = _expert_inputs(e, cap, d, f, dtype)

    def k4(a, w):
        return moe._ExpertMatmul.apply(a, w, te, tm, "auto")

    def einsum(a, w):
        return torch.einsum("ecd,edf->ecf", a.view(e, cap, -1), w).reshape(e * cap, -1)

    outs, grads = [], []
    for mm in (k4, einsum):
        leaves = [t.clone().requires_grad_() for t in (x, wg, wu, wd)]
        y = _expert_block(mm, *leaves, gated)
        used = leaves if gated else [leaves[0], leaves[2], leaves[3]]
        outs.append(y.detach())
        grads.append(torch.autograd.grad(y, used, g))
    assert outs[0].dtype == dtype
    _within_scale(outs[0], outs[1], GMM_TOL[dtype], "y")
    for name, a, b in zip(("dx", "dwg", "dwu", "dwd") if gated else ("dx", "dwu", "dwd"),
                          *grads):
        assert a.dtype == dtype and a.shape == b.shape, name
        _within_scale(a, b, GMM_TOL[dtype], name)


@pytest.fixture
def recorded(monkeypatch):
    """Every ``ops.grouped_matmul`` call the MoE layer makes: (x's shape,
    w's shape, tile experts, tm); each runs K4's plain version."""
    calls = []

    def stub(x, w, tile_expert, *, tm=128, backend="auto"):
        calls.append((tuple(x.shape), tuple(w.shape), tile_expert.tolist(), tm))
        return ref.moe_gmm_ref(x, w, tile_expert, tm)

    monkeypatch.setattr(ops, "grouped_matmul", stub)
    return calls


@pytest.mark.parametrize("needs", [(True, True), (True, False), (False, True)])
@pytest.mark.parametrize("cap", [16, 24])
def test_expert_matmul_backward_makes_two_grouped_matmuls(recorded, cap, needs):
    """One call forward; backward dx = [E*C, F] x [E, F, D] on the forward's
    tiles and dw = [E*D, C'] x [E, C', F] on tiles of D rows per expert, C'
    the capacity padded to a multiple of 16; a product whose input needs
    no gradient is not made."""
    e, d, f = 3, 32, 48
    tm = moe._tile_rows(cap)
    te = torch.arange(e, dtype=torch.int32).repeat_interleave(cap // tm)
    x, w, _, _, _ = _expert_inputs(e, cap, d, f, torch.float32)
    x.requires_grad_(needs[0])
    w.requires_grad_(needs[1])
    y = moe._ExpertMatmul.apply(x, w, te, tm, "auto")
    assert recorded == [((e * cap, d), (e, d, f), te.tolist(), tm)]
    got = torch.autograd.grad(y, [t for t, n in zip((x, w), needs) if n], torch.ones_like(y))
    c2 = cap + (-cap % 16)
    want = []
    if needs[0]:
        want.append(((e * cap, f), (e, f, d), te.tolist(), tm))
    if needs[1]:
        want.append(((e * d, c2), (e, c2, f), [i for i in range(e) for _ in range(d // 32)], 32))
    assert recorded[1:] == want
    assert [tuple(t.shape) for t in got] == [s for s, n in (((e * cap, d), needs[0]),
                                                            ((e, d, f), needs[1])) if n]


def test_moe_layer_train_step_counts_twelve_grouped_matmuls(recorded):
    """A reduced qwen3 train step under remat "full": per MoE layer 3
    grouped matmuls forward, 3 in the recompute and 6 in the backward."""
    cfg = registry.get_reduced("qwen3-moe-30b-a3b").with_(dtype="float32")
    assert cfg.remat == "full"
    params = tr.init_lm(0, cfg, device="cpu", trainable=True)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(cfg, 2, 32).batch_at(0).items()}
    opt = AdamW(lr=1e-3)
    make_train_step(cfg, opt)(params, opt.init(params), batch)
    assert len(recorded) == 12 * cfg.n_layers


# -- lm_loss and every gradient against the reference ----------------------------

def _ported(tree, cfg, trainable=False):
    return params_from_jax(jax.tree.map(np.asarray, tree), cfg, device="cpu",
                           trainable=trainable)


class _Model:
    def __init__(self, arch):
        self.r_cfg = r_registry.get_reduced(arch).with_(dtype="float32")
        self.p_cfg = registry.get_reduced(arch).with_(dtype="float32")
        self.r_params = r_tr.init_lm(jax.random.PRNGKey(0), self.r_cfg)

    def batch(self, b, s, seed=0):
        nb = SyntheticLM(self.r_cfg, b, s, seed=seed).batch_at(0)
        return ({k: jnp.asarray(v) for k, v in nb.items()},
                {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
                 for k, v in nb.items()})


# h2o at 64 positions, so that its reduced window of 32 masks.
GRAD_ARCHS = {"llama4-scout-17b-a16e": 32, "hubert-xlarge": 32, "paligemma-3b": 32,
              "h2o-danube-3-4b": 64}


@pytest.mark.parametrize("arch", list(GRAD_ARCHS))
def test_loss_and_every_gradient_match_reference(arch):
    """The MoE backward (llama4: capacity 24, the padding branch), the
    audio frontend with hubert's mask, the vision frontend's text slice
    and the sliding window, against ``jax.value_and_grad``."""
    m = _Model(arch)
    r_batch, p_batch = m.batch(2, GRAD_ARCHS[arch], seed=3)
    if m.p_cfg.has_moe:
        assert moe._capacity(2 * GRAD_ARCHS[arch], m.p_cfg) % 16 == 8
    (r_total, r_metrics), r_grads = jax.jit(jax.value_and_grad(
        lambda p: r_tr.lm_loss(p, m.r_cfg, **r_batch), has_aux=True))(m.r_params)
    params = _ported(m.r_params, m.p_cfg, trainable=True)
    total, metrics = tr.lm_loss(params, m.p_cfg, **p_batch)
    grads = torch.autograd.grad(total, tree_leaves(params))
    np.testing.assert_allclose(float(total.detach()), float(r_total), rtol=LOSS_RTOL)
    for k in ("loss", "moe_aux"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(r_metrics[k]), rtol=LOSS_RTOL,
                                   atol=1e-7)
    want = dict(flatten_with_paths(_ported(r_grads, m.p_cfg)))
    for (path, _), g in zip(flatten_with_paths(params), grads):
        _within_scale(g, want[path], GRAD_TOL, path)


def test_launch_train_lowers_the_moe_loss(tmp_path):
    """``launch_train`` of the reduced qwen3-moe-30b-a3b on the CPU (12
    steps of 8 x 32) lowers the loss, through the MoE layers' backward."""
    res = launch_train("qwen3-moe-30b-a3b", steps=12, batch=8, seq=32, ckpt_dir=str(tmp_path),
                       log_every=4, ckpt_every=100, device="cpu")
    losses = [h["loss"] for h in res["history"]]
    assert res["final_step"] == 12 and losses[-1] < losses[0]
    assert all(np.isfinite(losses))
